"""Resampling of the leading spatial axes of a tensor.

Counterpart of :mod:`darsia_tpu.ops.resize`: exact block means for
integer-factor shrinks and ``jax.image.resize`` otherwise.  That resize is
a separable resample: per axis, a weight matrix of a kernel (a triangle for
"linear", Keys' cubic for "cubic", Lanczos of radius 3 or 5) at the sample
positions ``(i + 0.5) * in / out - 0.5``, widened by the shrink factor when
antialiasing (every axis shrinks or keeps its extent), normalised, and zero
where a sample falls outside the input.  :func:`_resize_jax` builds the
same matrices in float32 and contracts each axis with them.  Linear 2-D
upsampling equals ``F.interpolate(mode="bilinear", align_corners=False)``,
which :func:`upsample_linear` calls; other shapes take the matrices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["downsample_mean", "resize_array", "upsample_linear"]

_METHODS = {
    "inter_nearest": "nearest",
    "inter_linear": "linear",
    "inter_cubic": "cubic",
    "inter_area": "linear",  # antialiased linear approximates area averaging
    "nearest": "nearest",
    "linear": "linear",
    "cubic": "cubic",
    "area": "linear",
}


def downsample_mean(data: torch.Tensor, factors: tuple) -> torch.Tensor:
    """Block-mean downsampling of the leading axes by integer factors (the
    extent is cropped to a multiple of each factor)."""
    dim = len(factors)
    new = [data.shape[d] // factors[d] for d in range(dim)]
    cropped = data[tuple(slice(0, new[d] * factors[d]) for d in range(dim))]
    shape = [s for d in range(dim) for s in (new[d], factors[d])]
    reshaped = cropped.reshape(shape + list(data.shape[dim:]))
    return reshaped.mean(dim=tuple(2 * d + 1 for d in range(dim)))


def upsample_linear(data: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Linear resampling of the ``len(shape)`` leading axes to ``shape``
    (``jax.image.resize`` with method "linear": an axis that shrinks is
    antialiased), in float32."""
    shape = tuple(int(s) for s in shape)
    work = data.to(torch.float32)
    if len(shape) != 2 or any(t < s for s, t in zip(data.shape, shape)):
        # jax.image.resize's default: each shrinking axis antialiased.
        return _resize_jax(work, shape, "linear", antialias=True)
    x = work.reshape(data.shape[:2] + (-1,)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=shape, mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).reshape(shape + tuple(data.shape[2:]))


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1 - x.abs()).clamp(min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        ones = torch.ones_like(x)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi**2 * x**2, ones), ones)
        return torch.where(x > radius, torch.zeros_like(x), out)

    return kernel


_KERNELS = {
    "linear": _triangle,
    "cubic": _keys_cubic,
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}

#: ``jax.image.resize``'s method names -> the kernel (or "nearest").
_JAX_METHODS = {
    "nearest": "nearest",
    "linear": "linear",
    "bilinear": "linear",
    "trilinear": "linear",
    "triangle": "linear",
    "cubic": "cubic",
    "bicubic": "cubic",
    "tricubic": "cubic",
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
}


def _weight_matrix(n_in: int, n_out: int, kernel, antialias: bool, device):
    """(n_in, n_out) float32 resampling weights of one axis, built on ``device``."""
    f32 = {"dtype": torch.float32, "device": device}
    # 1 / scale in float64, then float32, as JAX rounds it.
    inv_scale = torch.tensor(1.0 / (n_out / n_in), **f32)
    kernel_scale = inv_scale.clamp(min=1.0) if antialias else torch.tensor(1.0, **f32)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs()
    weights = kernel(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_jax(data: torch.Tensor, shape: tuple, method: str, antialias: bool):
    """``jax.image.resize(data, shape + data.shape[len(shape):], method,
    antialias)`` for float32 data.

    Raises:
        ValueError: a method name ``jax.image.resize`` does not know.

    """
    if method not in _JAX_METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    method = _JAX_METHODS[method]
    out = data
    for d, (n_in, n_out) in enumerate(zip(data.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = torch.arange(n_out, dtype=torch.float32, device=out.device) + 0.5
            out = out.index_select(d, (pos * n_in / n_out).floor().long())
            continue
        w = _weight_matrix(n_in, n_out, _KERNELS[method], antialias, out.device)
        out = torch.tensordot(out.movedim(d, -1), w, dims=1).movedim(-1, d)
    return out


def resize_array(
    data: torch.Tensor,
    shape: tuple,
    interpolation: str = "inter_linear",
    conservative: bool = False,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Resize the leading ``dim`` spatial axes of ``data`` to ``shape``.

    Args:
        data: tensor, spatial axes leading.
        shape: target spatial shape.
        interpolation: cv2-style ("inter_area", "inter_linear", ...) or a
            plain method name.
        conservative: rescale the values so the total sum (integral) is
            preserved, for extensive quantities.
        dim: number of spatial axes (default: ``len(shape)``).

    """
    dim = dim or len(shape)
    spatial = tuple(data.shape[:dim])
    target = tuple(int(s) for s in shape)
    if spatial == target:
        out = data
    else:
        method = _METHODS.get(interpolation.lower(), interpolation.lower())
        work = data.to(torch.float32)
        integer_down = all(s % t == 0 and s >= t for s, t in zip(spatial, target))
        if method == "linear" and integer_down:
            out = downsample_mean(work, tuple(s // t for s, t in zip(spatial, target)))
        else:
            antialias = all(t <= s for s, t in zip(spatial, target))
            out = _resize_jax(work, target, method, antialias)
    if conservative:
        out = out * (math.prod(spatial) / math.prod(target))
    return out
