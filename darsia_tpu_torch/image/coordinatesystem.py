"""Voxel <-> Cartesian coordinates of 2-D physical images.

Counterpart of :mod:`darsia_tpu.image.coordinatesystem` for the matrix
("ij") indexing of 2-D images: voxel (0, 0) is the top-left corner, x runs
along columns and y against rows, ``coord = origin + (col * dx, -row * dy)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CoordinateSystem"]


class CoordinateSystem:
    """Coordinate system of a 2-D physical image (host-side, numpy)."""

    def __init__(self, img) -> None:
        if img.space_dim != 2:
            raise NotImplementedError("only 2-D images are ported")
        self.indexing = img.indexing
        self.dim = 2
        self.shape = tuple(img.num_voxels)
        self.dimensions = list(img.dimensions)
        self.axes = "xy"
        vs = img.voxel_size
        self.voxel_size = {"x": vs[1], "y": vs[0]}
        self._coordinate_of_origin_voxel = np.asarray(img.origin, dtype=float)

    def coordinate(self, voxel) -> np.ndarray:
        """Voxel(s) (row, col) -> Cartesian coordinate(s) (x, y)."""
        voxel = np.asarray(voxel, dtype=float)
        v = np.atleast_2d(voxel)
        origin = self._coordinate_of_origin_voxel
        out = np.stack(
            [
                origin[0] + v[:, 1] * self.voxel_size["x"],
                origin[1] - v[:, 0] * self.voxel_size["y"],
            ],
            axis=1,
        )
        return out.reshape(voxel.shape)
