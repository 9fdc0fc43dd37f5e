"""Image arithmetics: weighting, superposition, stacking.

Counterpart of :mod:`darsia_tpu.image.arithmetics`; every result lies on the
device of the (first) image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import _resize_jax
from ..utils.dtype import as_torch_dtype
from .image import Image

__all__ = ["weight", "superpose", "stack", "zeros_like", "ones_like"]


def _linear_resize(data: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.image.resize(data, shape + rest, "linear")`` of float32 data."""
    return _resize_jax(data, tuple(shape), "linear", antialias=True)


def weight(img: Image, w) -> Image:
    """Scalar or element-wise weighting of an image."""
    weighted = img.copy()
    if isinstance(w, (float, int)) or np.isscalar(w):
        weighted.img = img.img * float(w)
    elif isinstance(w, Image):
        data = w.img.to(img.img.device, torch.float32)
        space_dim = img.space_dim
        if img.img.shape[:space_dim] != data.shape[:space_dim]:
            if space_dim != 2:
                raise NotImplementedError
            data = _linear_resize(data, tuple(img.img.shape[:2]))
        target = img.img.to(torch.float32)
        if target.dim() > data.dim():
            data = data.reshape(data.shape + (1,) * (target.dim() - data.dim()))
        weighted.img = target * data
    elif isinstance(w, np.ndarray) and tuple(w.shape) == tuple(img.shape[img.space_dim :]):
        # Spatially constant weight varying over time/range axes.
        target = img.img.to(torch.float32)
        shape = (1,) * img.space_dim + tuple(w.shape)
        factors = torch.from_numpy(np.asarray(w, dtype=np.float32)).to(target.device)
        weighted.img = target * factors.reshape(shape)
    else:
        raise ValueError("Unsupported weight type/shape.")
    return weighted


def superpose(images: list) -> Image:
    """Sum images defined on (possibly different) coordinate systems.

    The result lives on the bounding box of all inputs at the finest common
    voxel size; each image is embedded by coordinate lookup.
    """
    first = images[0]
    if any(img.space_dim != first.space_dim or img.scalar != first.scalar for img in images):
        raise ValueError("images of different dimension or range cannot be superposed")
    if first.space_dim != 2:
        raise NotImplementedError

    # Global bounding box (Cartesian).
    domains = [img.coordinatesystem.domain for img in images]
    xmin = min(d["xmin"] for d in domains)
    xmax = max(d["xmax"] for d in domains)
    ymin = min(d["ymin"] for d in domains)
    ymax = max(d["ymax"] for d in domains)

    # Finest voxel size.
    hy = min(img.voxel_size[0] for img in images)
    hx = min(img.voxel_size[1] for img in images)
    rows = int(np.ceil((ymax - ymin) / hy))
    cols = int(np.ceil((xmax - xmin) / hx))

    meta = first.metadata()
    meta["dimensions"] = [ymax - ymin, xmax - xmin]
    meta["origin"] = np.array([xmin, ymax])

    device = first.img.device
    extra = first.shape[first.space_dim :]
    total = torch.zeros((rows, cols, *extra), dtype=torch.float32, device=device)
    for img in images:
        data = img.img.to(device, torch.float32)
        # Embed: voxel (0, 0) of img at its global position.
        top_left = np.asarray(img.coordinatesystem.coordinate([0, 0]))
        r0 = int(round((ymax - top_left[1]) / hy))
        c0 = int(round((top_left[0] - xmin) / hx))
        # Resample img onto the common voxel size if needed.
        target_shape = (
            int(round(img.dimensions[0] / hy)),
            int(round(img.dimensions[1] / hx)),
        )
        if tuple(data.shape[:2]) != target_shape:
            data = _linear_resize(data, target_shape)
        r1 = min(r0 + data.shape[0], rows)
        c1 = min(c0 + data.shape[1], cols)
        total[r0:r1, c0:c1] += data[: r1 - r0, : c1 - c0]

    return type(first)(img=total, **meta)


def stack(images: list) -> Image:
    """Stack single-time images into a space-time series."""
    first = images[0]
    if any(img.shape != first.shape for img in images):
        raise ValueError("images of different shapes cannot be stacked")
    device = first.img.device
    data = torch.stack([img.img.to(device) for img in images], dim=first.space_dim)
    meta = first.metadata()
    meta["series"] = True
    meta["date"] = [img.date for img in images]
    times = [img.time for img in images]
    meta["time"] = times if not all(t is None for t in times) else None
    return type(first)(img=data, **meta)


def _filled_like(img: Image, value: float, mode: str, dtype):
    shape = img.shape if mode == "image" else tuple(img.num_voxels[: img.space_dim])
    dtype = torch.float32 if dtype is None else as_torch_dtype(dtype)
    data = torch.full(shape, value, dtype=dtype, device=img.img.device)
    if mode == "voxels":
        meta = img.metadata()
        meta["scalar"] = True
        meta["series"] = False
        return Image(data, **meta)
    return type(img)(img=data, **img.metadata())


def zeros_like(img: Image, mode: str = "image", dtype=None):
    """Zero image (mode="image") or zero spatial array (mode="voxels")."""
    return _filled_like(img, 0, mode, dtype)


def ones_like(img: Image, mode: str = "image", dtype=None):
    """Unit image / spatial array, analogous to :func:`zeros_like`."""
    return _filled_like(img, 1, mode, dtype)
