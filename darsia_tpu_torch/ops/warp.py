"""The warp engine: one resampling routine for all geometric corrections.

Counterpart of :mod:`darsia_tpu.ops.warp`.  A correction is a generator of a
coordinate field (the pull-back sampling positions, ``(dim, *out_shape)`` in
(row, col) order); :func:`warp` evaluates an image at those positions with
explicit gathers, and :func:`warp_backend` routes bounded 2-D fields on CUDA
tensors to the hand-written two-pass kernel (:mod:`.warp2pass`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .warp2pass import warp_two_pass

__all__ = [
    "PALLAS_MAX_DISP",
    "affine_grid",
    "compose_coordinate_maps",
    "displacement_grid",
    "identity_grid",
    "perspective_grid",
    "warp",
    "warp_backend",
]

#: Largest displacement bound routed to the two-pass kernel; the name and the
#: value follow the JAX package, where above it the window chain stopped
#: paying off against the gather warp.
PALLAS_MAX_DISP = 1024


def identity_grid(shape: tuple, device) -> torch.Tensor:
    """Identity coordinate field ``(dim, *shape)`` (float32) on ``device``."""
    axes = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=device) for n in shape],
        indexing="ij",
    )
    return torch.stack(axes, dim=0)


def _gather_nd(flat: torch.Tensor, idx: list) -> torch.Tensor:
    """``flat[idx0, idx1, ...]`` via one linear index; ``flat`` is (*spatial, K)."""
    dim = len(idx)
    spatial = flat.shape[:dim]
    linear = idx[0]
    for d in range(1, dim):
        linear = linear * spatial[d] + idx[d]
    table = flat.reshape(-1, flat.shape[-1])
    return table[linear.reshape(-1)].reshape(idx[0].shape + (flat.shape[-1],))


def warp(
    data: torch.Tensor,
    coords: torch.Tensor,
    order: int = 1,
    mode: str = "constant",
    cval: float = 0.0,
) -> torch.Tensor:
    """Resample ``data`` at (fractional) voxel positions ``coords``.

    Args:
        data: ``(*spatial, *channels)`` with ``coords.shape[0]`` spatial axes.
        coords: ``(dim, *out_spatial)`` input positions per output voxel.
        order: 0 (nearest) or 1 (bilinear/trilinear).
        mode: "constant" (fill outside with ``cval``) or "nearest" (clamp).
        cval: fill value for ``mode="constant"``.

    Returns:
        ``(*out_spatial, *channels)`` float32 tensor.

    """
    dim = coords.shape[0]
    spatial = tuple(data.shape[:dim])
    channels = tuple(data.shape[dim:])
    out_spatial = tuple(coords.shape[1:])

    flat = data.reshape(spatial + (-1,)) if channels else data[..., None]
    flat = flat.to(torch.float32)
    coords = coords.to(torch.float32)
    upper = torch.tensor(
        [s - 1 for s in spatial], dtype=torch.float32, device=coords.device
    ).reshape((dim,) + (1,) * len(out_spatial))

    if order == 0:
        idx = torch.round(coords)
        valid = ((idx >= 0) & (idx <= upper)).all(dim=0)
        idx = torch.minimum(idx.clamp(min=0.0), upper).long()
        out = _gather_nd(flat, [idx[d] for d in range(dim)])
    elif order == 1:
        lo = torch.floor(coords)
        frac = coords - lo
        valid = ((coords >= 0) & (coords <= upper)).all(dim=0)
        out = None
        # The 2^dim interpolation corners, in the JAX package's order.
        for corner in range(2**dim):
            offs = [(corner >> d) & 1 for d in range(dim)]
            idx = [
                (lo[d] + offs[d]).clamp(0.0, float(spatial[d] - 1)).long()
                for d in range(dim)
            ]
            weight = torch.ones(out_spatial, dtype=torch.float32, device=coords.device)
            for d in range(dim):
                weight = weight * (frac[d] if offs[d] else (1.0 - frac[d]))
            contrib = _gather_nd(flat, idx) * weight[..., None]
            out = contrib if out is None else out + contrib
    else:
        raise NotImplementedError("Only order 0 and 1 supported.")
    if mode == "constant":
        out = torch.where(valid[..., None], out, cval)

    if channels:
        return out.reshape(out_spatial + channels)
    return out[..., 0]


def warp_backend(
    data: torch.Tensor,
    coords: torch.Tensor,
    order: int = 1,
    mode: str = "constant",
    cval: float = 0.0,
    max_disp: Optional[int] = None,
    force: Optional[str] = None,
    warp_impl: str = "auto",
) -> torch.Tensor:
    """Device-dispatching warp: two-pass kernel on CUDA, gather otherwise.

    Same semantics as :func:`warp` (including the ``mode="constant"`` fill).
    A bilinear 2-D warp of a CUDA tensor whose displacement bound
    ``max_disp`` (max |coords - identity|) is known and at most
    :data:`PALLAS_MAX_DISP` runs the two-pass kernel; on the CPU the gather
    warp runs, as the JAX package does off the TPU.

    Args:
        max_disp: displacement bound; derived eagerly for CUDA tensors when
            None (one reduction and a host sync: a setup-time cost).
        force: "kernel" (two-pass on any device: the plain K1 on CPU) or
            "gather"; for tests and checks only.
        warp_impl: passed to :func:`~.warp2pass.warp_rows_t` ("plain" routes
            the two-pass through the plain K1; for checks only).

    """
    if force not in (None, "kernel", "gather"):
        raise ValueError(f"unknown force {force!r}")
    two_pass_ok = order == 1 and coords.shape[0] == 2 and data.dim() in (2, 3)
    on_cuda = data.device.type == "cuda"
    if max_disp is None and force is None and two_pass_ok and on_cuda:
        ident = identity_grid(tuple(coords.shape[1:]), coords.device)
        bound = float((coords - ident).abs().max())
        if math.isfinite(bound):
            max_disp = int(math.ceil(bound)) + 1
    use_kernel = force == "kernel" or (
        force is None
        and two_pass_ok
        and on_cuda
        and max_disp is not None
        and max_disp <= PALLAS_MAX_DISP
    )
    if not use_kernel:
        return warp(data, coords, order=order, mode=mode, cval=cval)
    if max_disp is None:
        raise ValueError("the two-pass warp needs max_disp")

    out = warp_two_pass(
        data.to(torch.float32), coords.to(torch.float32), int(max_disp), warp_impl
    )
    if mode == "constant":
        upper = torch.tensor(
            [data.shape[0] - 1, data.shape[1] - 1],
            dtype=torch.float32,
            device=coords.device,
        ).reshape(2, 1, 1)
        valid = ((coords >= 0) & (coords <= upper)).all(dim=0)
        out = torch.where(valid[..., None] if out.dim() == 3 else valid, out, cval)
    return out


def affine_grid(matrix, translation, out_shape: tuple, device) -> torch.Tensor:
    """Coordinate field of an affine pull-back map, on ``device``: output
    voxel ``p`` samples the input at ``matrix @ p + translation``.

    The products are summed axis by axis in float32 (no matmul), so the
    field is the same on every device, down to the last bit: a nearest-voxel
    warp of it picks the same voxels on the card as on the CPU.

    Args:
        matrix: (dim, dim) array-like.
        translation: (dim,) array-like.
        out_shape: output spatial shape.

    """
    matrix = np.asarray(matrix, dtype=np.float32)
    translation = np.asarray(translation, dtype=np.float32)
    grid = identity_grid(tuple(out_shape), device)
    rows = []
    for d in range(len(out_shape)):
        acc = grid[0] * float(matrix[d, 0])
        for e in range(1, len(out_shape)):
            acc = acc + grid[e] * float(matrix[d, e])
        rows.append(acc + float(translation[d]))
    return torch.stack(rows, dim=0)


def displacement_grid(displacement: torch.Tensor) -> torch.Tensor:
    """Coordinate field of a ``(dim, *shape)`` voxel displacement field, on
    its device: output voxel ``p`` samples the input at
    ``p + displacement[:, p]``."""
    return identity_grid(tuple(displacement.shape[1:]), displacement.device) + displacement


def perspective_grid(homography: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """Coordinate field of a 2-D projective pull-back map.

    ``homography`` is a float32 (3, 3) tensor acting on homogeneous
    (row, col, 1) vectors; the field lies on the homography's device.
    """
    grid = identity_grid(out_shape, homography.device)
    ones = torch.ones((1,) + tuple(out_shape), dtype=torch.float32, device=grid.device)
    homo = torch.cat([grid, ones], dim=0).reshape(3, -1)
    mapped = homography @ homo
    mapped = mapped[:2] / mapped[2:3]
    return mapped.reshape((2,) + tuple(out_shape))


def compose_coordinate_maps(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """Compose two coordinate fields: ``result(p) = inner(outer(p))``."""
    return torch.stack(
        [warp(inner[d], outer, order=1, mode="nearest") for d in range(outer.shape[0])],
        dim=0,
    )
