"""Voxel <-> Cartesian coordinates of physical images in 1, 2 and 3 dimensions.

Counterpart of :mod:`darsia_tpu.image.coordinatesystem`.  The map is affine
per axis, ``coord = origin +/- voxel * h``, with the matrix ("i", "ij",
"ijk") indexing of the image: in 2-D x runs along columns and y against rows,
in 3-D z runs against axis 0, x along axis 1 and y against axis 2
(:func:`~darsia_tpu_torch.image.indexing.interpret_indexing`).
:class:`CoordinateSystem` is host-side numpy; :func:`voxels_to_coordinates`
and :func:`coordinates_to_voxels` are the same map on tensors.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..utils.point import (
    Coordinate,
    CoordinateArray,
    Voxel,
    VoxelArray,
    make_coordinate,
    make_voxel,
)
from .indexing import interpret_indexing

__all__ = [
    "CoordinateSystem",
    "check_equal_coordinatesystems",
    "coordinates_to_voxels",
    "voxels_to_coordinates",
]


def check_equal_coordinatesystems(
    cs1: "CoordinateSystem", cs2: "CoordinateSystem", exclude_size: bool = False
) -> tuple:
    """Compare two coordinate systems; returns (equal, failure log)."""
    log = []
    if cs1.dim != cs2.dim:
        log.append("dimension mismatch")
    if cs1.indexing != cs2.indexing:
        log.append("indexing mismatch")
    if not np.allclose(cs1.dimensions, cs2.dimensions):
        log.append("dimensions mismatch")
    if not np.allclose(cs1._coordinate_of_origin_voxel, cs2._coordinate_of_origin_voxel):
        log.append("origin mismatch")
    if not exclude_size and cs1.shape != cs2.shape:
        log.append("shape mismatch")
    return len(log) == 0, log


class CoordinateSystem:
    """Coordinate system of a physical image (host-side, numpy)."""

    def __init__(self, img) -> None:
        if img.indexing not in ("i", "ij", "ijk"):
            raise ValueError(f"indexing {img.indexing!r} not supported")
        self.indexing = img.indexing
        self.dim = img.space_dim
        self.shape = tuple(img.num_voxels)
        self.dimensions = list(img.dimensions)
        self.axes = "xyz"[: self.dim]
        # Per Cartesian axis: its matrix axis and whether it runs against it.
        self._layout = [interpret_indexing(axis, self.indexing) for axis in self.axes]
        self.voxel_size = {
            axis: img.voxel_size[pos] for axis, (pos, _) in zip(self.axes, self._layout)
        }
        self._coordinate_of_origin_voxel = np.asarray(img.origin, dtype=float)
        self._coordinate_of_opposite_voxel = self.coordinate(list(self.shape))
        # The Cartesian bounding box, from the two opposite corner voxels.
        corners = np.vstack(
            (
                self._coordinate_of_origin_voxel,
                np.asarray(self._coordinate_of_opposite_voxel),
            )
        )
        self.min_coordinate = corners.min(axis=0)
        self.max_coordinate = corners.max(axis=0)
        self.domain = {}
        for i, axis in enumerate(self.axes):
            self.domain[axis + "min"] = float(self.min_coordinate[i])
            self.domain[axis + "max"] = float(self.max_coordinate[i])

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

    def _check_axis(self, axis: str) -> None:
        if axis not in self.axes:
            raise ValueError(f"unknown axis {axis!r}")

    def length(self, num, axis: str):
        """A voxel count along a Cartesian ``axis`` as a metric length."""
        self._check_axis(axis)
        return num * self.voxel_size[axis]

    def num_voxels(self, length, axis: str):
        """A metric length along a Cartesian ``axis`` as a voxel count (ceil)."""
        self._check_axis(axis)
        return np.ceil(length / self.voxel_size[axis]).astype(int)

    def _signed_sizes(self):
        """Per Cartesian axis: (matrix axis, signed voxel size)."""
        return [
            (pos, (-1.0 if revert else 1.0) * self.voxel_size[axis])
            for axis, (pos, revert) in zip(self.axes, self._layout)
        ]

    def coordinate(self, voxel) -> Union[Coordinate, CoordinateArray]:
        """Voxel(s) in matrix indexing -> Cartesian coordinate(s)."""
        voxel = np.asarray(voxel)
        v = np.atleast_2d(voxel)
        origin = self._coordinate_of_origin_voxel
        out = np.empty(v.shape, dtype=float)
        for i, (axis, (pos, revert)) in enumerate(zip(self.axes, self._layout)):
            scaling = -1.0 if revert else 1.0
            out[:, i] = origin[i] + scaling * v[:, pos] * self.voxel_size[axis]
        return make_coordinate(out.reshape(voxel.shape))

    def voxel(self, coordinate) -> Union[Voxel, VoxelArray]:
        """Cartesian coordinate(s) -> voxel(s) in matrix indexing, floored."""
        coordinate = np.asarray(coordinate, dtype=float)
        c = np.atleast_2d(coordinate)
        origin = self._coordinate_of_origin_voxel
        out = np.empty(c.shape, dtype=int)
        for i, (axis, (pos, revert)) in enumerate(zip(self.axes, self._layout)):
            scaling = -1.0 if revert else 1.0
            out[:, pos] = np.floor(scaling * (c[:, i] - origin[i]) / self.voxel_size[axis])
        return make_voxel(out.reshape(coordinate.shape))

    def coordinate_vector(self, voxel_vector) -> np.ndarray:
        """Relative voxel displacement vector(s) as Cartesian vector(s)."""
        vectors = np.atleast_2d(np.asarray(voxel_vector, dtype=float))
        out = np.empty(vectors.shape, dtype=float)
        for i, (pos, size) in enumerate(self._signed_sizes()):
            out[:, i] = vectors[:, pos] * size
        return out.reshape(np.asarray(voxel_vector).shape)

    def voxel_vector(self, coordinate_vector) -> np.ndarray:
        """Cartesian vector(s) as voxel displacement vector(s) (not floored)."""
        vectors = np.atleast_2d(np.asarray(coordinate_vector, dtype=float))
        out = np.empty(vectors.shape, dtype=float)
        for i, (pos, size) in enumerate(self._signed_sizes()):
            out[:, pos] = vectors[:, i] / size
        return out.reshape(np.asarray(coordinate_vector).shape)

    def pixel_vector(self, coordinate_vector) -> np.ndarray:
        """Alias of :meth:`voxel_vector`."""
        return self.voxel_vector(coordinate_vector)

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


def _axis_tables(indexing: str, dim: int):
    """Per Cartesian axis: the matrix axis and the sign of the map."""
    layout = [interpret_indexing(axis, indexing) for axis in "xyz"[:dim]]
    return [p for p, _ in layout], [-1.0 if revert else 1.0 for _, revert in layout]


def voxels_to_coordinates(
    voxels: torch.Tensor,
    origin: torch.Tensor,
    voxel_size: torch.Tensor,
    indexing: str = "ij",
) -> torch.Tensor:
    """Vectorised voxel -> coordinate map on tensors.

    Args:
        voxels: (..., dim) voxel positions in matrix indexing order.
        origin: (dim,) Cartesian coordinate of voxel 0.
        voxel_size: (dim,) voxel size per Cartesian axis (x, y, z).
        indexing: matrix indexing scheme.

    Returns:
        (..., dim) Cartesian coordinates.

    """
    pos, sign = _axis_tables(indexing, voxels.shape[-1])
    sign = torch.tensor(sign, dtype=voxel_size.dtype, device=voxels.device)
    return origin + sign * voxels[..., pos] * voxel_size


def coordinates_to_voxels(
    coords: torch.Tensor,
    origin: torch.Tensor,
    voxel_size: torch.Tensor,
    indexing: str = "ij",
    continuous: bool = False,
) -> torch.Tensor:
    """Vectorised coordinate -> voxel map on tensors: fractional voxels with
    ``continuous`` (for interpolation), else floored to int32.

    Args:
        coords: (..., dim) Cartesian coordinates.
        origin: (dim,) Cartesian coordinate of voxel 0.
        voxel_size: (dim,) per Cartesian axis.
        indexing: matrix indexing scheme.
        continuous: keep fractional voxels.

    Returns:
        (..., dim) voxels in matrix indexing order.

    """
    dim = coords.shape[-1]
    pos, sign = _axis_tables(indexing, dim)
    sign = torch.tensor(sign, dtype=voxel_size.dtype, device=coords.device)
    frac_cart = sign * (coords - origin) / voxel_size
    inv = [pos.index(k) for k in range(dim)]
    frac = frac_cart[..., inv]
    return frac if continuous else torch.floor(frac).to(torch.int32)
