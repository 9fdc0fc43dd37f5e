"""Voxel <-> Cartesian coordinates of 2-D physical images.

Counterpart of :mod:`darsia_tpu.image.coordinatesystem` for the matrix
("ij") indexing of 2-D images: voxel (0, 0) is the top-left corner, x runs
along columns and y against rows, ``coord = origin + (col * dx, -row * dy)``.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ..utils.point import (
    Coordinate,
    CoordinateArray,
    Voxel,
    VoxelArray,
    make_coordinate,
    make_voxel,
)

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
        # The Cartesian bounding box, from the two opposite corner voxels.
        corners = np.vstack(
            (self._coordinate_of_origin_voxel, np.asarray(self.coordinate(list(self.shape))))
        )
        self.min_coordinate = corners.min(axis=0)
        self.max_coordinate = corners.max(axis=0)
        self.domain = {
            "xmin": float(self.min_coordinate[0]),
            "xmax": float(self.max_coordinate[0]),
            "ymin": float(self.min_coordinate[1]),
            "ymax": float(self.max_coordinate[1]),
        }

    @property
    def voxels(self) -> VoxelArray:
        """All voxels of the image, in column-major (Fortran) order."""
        if not hasattr(self, "_voxels"):
            self._voxels = make_voxel(
                np.indices(self.shape, dtype=int).reshape((self.dim, -1), order="F").T
            )
        return self._voxels

    @property
    def coordinates(self) -> CoordinateArray:
        """Cartesian coordinates of all voxels (order of :attr:`voxels`)."""
        if not hasattr(self, "_coordinates"):
            self._coordinates = self.coordinate(self.voxels)
        return self._coordinates

    def length(self, num, axis: str):
        """A voxel count along ``axis`` ("x" or "y") as a metric length."""
        if axis not in self.axes:
            raise ValueError(f"unknown axis {axis!r}")
        return num * self.voxel_size[axis]

    def num_voxels(self, length, axis: str):
        """A metric length along ``axis`` as a voxel count (ceil)."""
        if axis not in self.axes:
            raise ValueError(f"unknown axis {axis!r}")
        return np.ceil(length / self.voxel_size[axis]).astype(int)

    def coordinate(self, voxel) -> Union[Coordinate, CoordinateArray]:
        """Voxel(s) (row, col) -> Cartesian coordinate(s) (x, y)."""
        voxel = np.asarray(voxel)
        v = np.atleast_2d(voxel).astype(float)
        origin = self._coordinate_of_origin_voxel
        out = np.stack(
            [
                origin[0] + v[:, 1] * self.voxel_size["x"],
                origin[1] - v[:, 0] * self.voxel_size["y"],
            ],
            axis=1,
        )
        return make_coordinate(out.reshape(voxel.shape))

    def voxel(self, coordinate) -> Union[Voxel, VoxelArray]:
        """Cartesian coordinate(s) (x, y) -> voxel(s) (row, col), floored."""
        coordinate = np.asarray(coordinate, dtype=float)
        c = np.atleast_2d(coordinate)
        origin = self._coordinate_of_origin_voxel
        out = np.stack(
            [
                np.floor(-(c[:, 1] - origin[1]) / self.voxel_size["y"]),
                np.floor((c[:, 0] - origin[0]) / self.voxel_size["x"]),
            ],
            axis=1,
        ).astype(int)
        return make_voxel(out.reshape(coordinate.shape))

    def __eq__(self, other) -> bool:
        if not isinstance(other, CoordinateSystem):
            return NotImplemented
        return (
            self.indexing == other.indexing
            and self.shape == other.shape
            and np.allclose(self.dimensions, other.dimensions)
            and np.allclose(
                self._coordinate_of_origin_voxel, other._coordinate_of_origin_voxel
            )
        )
