"""Rotation correction around an anchor voxel (2d/3d).

Counterpart of :mod:`darsia_tpu.corrections.shape.rotation`.  The pull-back
field is an affine grid on the image's device; the resampling is the
nearest-voxel gather warp.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ...ops.warp import affine_grid, warp
from ...utils.npz import load_npz
from ..base import BaseCorrection
from .affine import AffineTransformation, axis_rotations, plane_rotation

__all__ = ["RotationCorrection"]


class RotationCorrection(BaseCorrection):
    """Rotate image data around an anchor voxel.

    Args:
        anchor: rotation anchor (voxel, matrix indexing).
        kwargs: either ``rotations`` (2d: [angle]; 3d: list of
            (angle, cartesian_axis) pairs) or ``rotation_from_isometry=True``
            with ``pts_src``/``pts_dst`` point pairs.

    """

    def __init__(self, anchor: Union[list, np.ndarray], **kwargs) -> None:
        self.anchor = np.asarray(anchor, dtype=float)
        dim = len(self.anchor)
        self.dim = dim

        if kwargs.get("rotation_from_isometry", False):
            pts_src = np.asarray(kwargs["pts_src"], dtype=float)
            pts_dst = np.asarray(kwargs["pts_dst"], dtype=float)
            affine_map = AffineTransformation(dim)
            affine_map.fit(pts_src, pts_dst, {"isometry": True})
            self.rotation = affine_map.rotation
            self.rotation_inv = np.linalg.inv(affine_map.rotation)
        else:
            rotations = kwargs.get("rotations")
            if rotations is None:
                raise ValueError("No means provided to determine rotations.")
            if dim == 2:
                self.rotation, self.rotation_inv = plane_rotation(rotations[0])
            elif dim == 3:
                self.rotation, self.rotation_inv = axis_rotations(rotations, dim)

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        spatial = tuple(img.shape[: self.dim])
        # Pull-back: p_src = anchor + R^-1 (p_dst - anchor).
        translation = self.anchor - self.rotation_inv @ self.anchor
        coords = affine_grid(self.rotation_inv, translation, spatial, img.device)
        dtype = img.dtype
        out = warp(img.to(torch.float32), coords, order=0)
        if not dtype.is_floating_point:
            out = torch.round(out)
        return out.to(dtype)

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            class_name=type(self).__name__,
            anchor=self.anchor,
            rotation=self.rotation,
            rotation_inv=self.rotation_inv,
        )

    def load(self, path) -> None:
        data = load_npz(path)
        self.anchor = data["anchor"]
        self.dim = len(self.anchor)
        self.rotation = data["rotation"]
        self.rotation_inv = data["rotation_inv"]
