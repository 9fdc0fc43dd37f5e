"""Piecewise perspective transform of patched images.

Counterpart of :mod:`darsia_tpu.corrections.shape.piecewiseperspective`: the
per-patch displacements are interpolated into one smooth coordinate field
(thin-plate spline, evaluated on the image's device) and applied in a single
bilinear warp: on a CUDA tensor the two-pass kernel, at the bound read from
the field (one reduction and host read per call).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...image.image import Image
from ...ops.warp import identity_grid, warp_backend
from ...utils.interpolation import rbf_interpolate

__all__ = ["PiecewisePerspectiveTransform"]


class PiecewisePerspectiveTransform:
    """Warp an image by per-patch displacements."""

    def __init__(self, **kwargs) -> None:
        self.have_transform = False

    def find_and_warp(self, patches, displacement: np.ndarray, reverse: bool = False) -> Image:
        """Interpolate patch-center displacements and warp in one pass.

        Args:
            patches: Patches object of the image to warp.
            displacement: per-patch displacement, shape (N_i, N_j, 2) in
                (x, y) pixel convention (or flattened (N, 2)).
            reverse: flip the displacement direction.

        """
        base = patches.base
        data = base.img
        device = data.device
        H, W = base.num_voxels[:2]
        centers = patches.centers_voxels.reshape(-1, 2)
        disp = np.asarray(displacement, dtype=float).reshape(-1, 2)
        if reverse:
            disp = -disp

        pts = np.stack([centers[:, 1], centers[:, 0]], axis=1)  # (x, y)
        grid = identity_grid((H, W), device)
        if pts.shape[0] >= 3:
            query = torch.stack([grid[1].reshape(-1), grid[0].reshape(-1)], dim=1)
            dx = rbf_interpolate(pts, disp[:, 0], query).reshape(H, W)
            dy = rbf_interpolate(pts, disp[:, 1], query).reshape(H, W)
        else:
            dx = torch.full((H, W), float(disp[:, 0].mean()), dtype=torch.float32, device=device)
            dy = torch.full((H, W), float(disp[:, 1].mean()), dtype=torch.float32, device=device)
        field = torch.stack([dy, dx])
        max_disp = int(math.ceil(float(field.abs().max()))) + 1
        out = warp_backend(data.to(torch.float32), grid - field, order=1, max_disp=max_disp)
        self.have_transform = True
        result = base.copy()
        result.img = out.to(data.dtype)
        return result
