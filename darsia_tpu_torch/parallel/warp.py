"""Spatially sharded warps: domain-decomposed resampling over a 2-d mesh.

Counterpart of :mod:`darsia_tpu.parallel.warp`.  A warp whose displacement
is bounded by ``max_disp`` is local up to a ``max_disp`` halo: each mesh
position owns one (rows, cols) tile of the output, receives a
``max_disp``-wide halo of the input from its neighbours (corner-correct,
:func:`~darsia_tpu_torch.parallel.halo.halo_exchange_2d`) and resamples its
tile with the exact gather warp (:func:`darsia_tpu_torch.ops.warp.warp`).
The result equals the single-device ``warp`` up to float32 rounding: the
bilinear weights are evaluated at tile-local coordinates.
"""

from __future__ import annotations

import torch

from ..ops.warp import warp
from .halo import halo_exchange_2d
from .mesh import Mesh, Placement, at

__all__ = ["sharded_warp"]


def sharded_warp(
    mesh: Mesh,
    image_shape: tuple,
    max_disp: int,
    row_axis: str = "rows",
    col_axis: str = "cols",
    order: int = 1,
    cval: float = 0.0,
):
    """Build a sharded warp over a (rows, cols) space mesh.

    Args:
        mesh: device mesh with the axes ``row_axis`` and ``col_axis``.
        image_shape: global (H, W); the mesh axes must divide them.
        max_disp: bound on |coords - identity| (the halo width).
        order: interpolation order (0 or 1, as in :func:`~darsia_tpu_torch.ops.warp.warp`).
        cval: fill value outside the global domain.

    Returns:
        ``apply(data, coords) -> warped`` taking the global (H, W[, C])
        image and (2, H, W) pull-back coordinate field and returning the
        warped global image on the mesh's first device.
    """
    H, W = image_shape
    pr, pc = mesh.shape[row_axis], mesh.shape[col_axis]
    if H % pr or W % pc:
        raise ValueError(f"image {image_shape} must tile the ({pr}, {pc}) space mesh")
    if mesh.axis_names != (row_axis, col_axis):
        raise ValueError(f"mesh axes {mesh.axis_names}, want ({row_axis!r}, {col_axis!r})")
    lh, lw = H // pr, W // pc
    D = int(max_disp)
    if D >= min(lh, lw):
        raise ValueError("halo width must be smaller than the local tile; use a coarser mesh")
    coords_placement = Placement(mesh, (None, row_axis, col_axis))

    def per_shard(ext, coords_local, i, j):
        # The extended block covers global positions
        # [i0 - D, i0 + lh + D) x [j0 - D, j0 + lw + D).  |coords - identity|
        # <= D keeps every clamped sample inside it; clamping first
        # reproduces the single-device bilinear arithmetic, the validity
        # mask the fill outside the global domain.
        i0, j0 = float(i * lh), float(j * lw)
        rows = coords_local[0].clamp(0.0, float(H - 1))
        cols = coords_local[1].clamp(0.0, float(W - 1))
        local_coords = torch.stack([rows - (i0 - D), cols - (j0 - D)])
        out = warp(ext, local_coords, order=order, mode="constant", cval=cval)
        valid = (
            (coords_local[0] >= 0)
            & (coords_local[0] <= H - 1)
            & (coords_local[1] >= 0)
            & (coords_local[1] <= W - 1)
        )
        if out.dim() == 3:
            valid = valid[..., None]
        return torch.where(valid, out, cval)

    def apply(data, coords) -> torch.Tensor:
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(data)
        if data.dim() not in (2, 3):
            raise ValueError("data must be (H, W) or (H, W, C)")
        space = Placement(mesh, (row_axis, col_axis) + (None,) * (data.dim() - 2))
        tiles = space.split(data.to(torch.float32))
        fields = coords_placement.split(torch.as_tensor(coords).to(torch.float32))
        ext = halo_exchange_2d(tiles, D)
        out = [
            [per_shard(ext[i][j], at(fields, (i, j)), i, j) for j in range(pc)]
            for i in range(pr)
        ]
        return space.join(out)

    return apply
