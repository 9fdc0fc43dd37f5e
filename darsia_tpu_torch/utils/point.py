"""Physical points: Cartesian coordinates vs. voxel indices.

Counterpart of :mod:`darsia_tpu.utils.point` (the point types, their
constructors and conversions).  Host-side metadata types (numpy subclasses): device code never
sees them; they let user-facing calls tell "a position in meters" from "a
position in array indices", converted by a
:class:`~darsia_tpu_torch.image.coordinatesystem.CoordinateSystem`.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np

__all__ = [
    "BasePoint",
    "Coordinate",
    "CoordinateArray",
    "Voxel",
    "VoxelArray",
    "VoxelCenter",
    "VoxelCenterArray",
    "make_coordinate",
    "make_voxel",
    "make_voxel_center",
    "to_coordinate",
    "to_voxel",
    "to_voxel_center",
]


class BasePoint(np.ndarray):
    """Base class of the physical point types (ndarray view subclass)."""

    def __new__(cls, input_array=None):
        if input_array is None:
            input_array = np.empty(0)
        return np.asarray(input_array).view(cls)

    def __array_finalize__(self, obj):
        pass

    def to(self, cls, coordinatesystem=None):
        """This point as another point type.

        Args:
            cls: target class (Coordinate, Voxel, VoxelCenter or their array
                types).
            coordinatesystem: needed between physical and voxel space.

        """
        return _convert_point(self, cls, coordinatesystem)

    def to_coordinate(self, coordinatesystem=None):
        return to_coordinate(self, coordinatesystem)

    def to_voxel(self, coordinatesystem=None):
        return to_voxel(self, coordinatesystem)

    def to_voxel_center(self, coordinatesystem=None):
        return to_voxel_center(self, coordinatesystem)


class Coordinate(BasePoint):
    """Cartesian coordinate (xyz ordering), float-valued."""

    def __new__(cls, input_array=None):
        if input_array is None:
            input_array = np.empty(0)
        return np.asarray(input_array, dtype=float).view(cls)


class Voxel(BasePoint):
    """Voxel index (matrix ijk ordering), int-valued.

    Args:
        input_array: raw index data (floored).
        matrix_indexing: if False, the input is in Cartesian (xy) ordering and
            the leading two components are swapped into matrix ordering.

    """

    def __new__(cls, input_array, matrix_indexing: bool = True):
        arr = np.floor(np.atleast_1d(np.asarray(input_array)).astype(float)).astype(int)
        if not matrix_indexing:
            arr = _swap_leading(arr)
        return arr.view(cls)


class VoxelCenter(BasePoint):
    """Center of a voxel: voxel index + 0.5 per axis (matrix ordering)."""

    def __new__(cls, input_array, matrix_indexing: bool = True):
        arr = np.floor(np.atleast_1d(np.asarray(input_array, dtype=float))) + 0.5
        if not matrix_indexing:
            arr = _swap_leading(arr)
        return arr.view(cls)


class CoordinateArray(Coordinate):
    """2-D array of coordinates, one per row."""

    def __getitem__(self, key: Any) -> Union[Coordinate, "CoordinateArray", np.ndarray]:
        return _wrap_item(np.asarray(self)[key], Coordinate, CoordinateArray)


class VoxelArray(Voxel):
    """2-D array of voxels, one per row."""

    def __new__(cls, input_array, matrix_indexing: bool = True):
        return Voxel.__new__(cls, input_array, matrix_indexing)

    def __getitem__(self, key: Any) -> Union[Voxel, "VoxelArray", np.ndarray]:
        return _wrap_item(np.asarray(self)[key], Voxel, VoxelArray)


class VoxelCenterArray(VoxelCenter):
    """2-D array of voxel centers, one per row."""

    def __new__(cls, input_array, matrix_indexing: bool = True):
        return VoxelCenter.__new__(cls, input_array, matrix_indexing)

    def __getitem__(self, key: Any) -> Union[VoxelCenter, "VoxelCenterArray", np.ndarray]:
        return _wrap_item(np.asarray(self)[key], VoxelCenter, VoxelCenterArray)


def _swap_leading(arr: np.ndarray) -> np.ndarray:
    """Swap the two leading spatial components (xy <-> ij)."""
    arr = np.array(arr)
    if arr.ndim == 1:
        arr[[0, 1]] = arr[[1, 0]]
    else:
        arr[:, [0, 1]] = arr[:, [1, 0]]
    return arr


def _wrap_item(item: np.ndarray, single_cls, array_cls):
    item = np.asarray(item)
    if item.ndim == 1:
        return item.view(single_cls)
    if item.ndim == 2:
        return item.view(array_cls)
    return item


def make_coordinate(pts) -> Union[Coordinate, CoordinateArray]:
    """A Coordinate (1-D input) or a CoordinateArray (2-D input)."""
    arr = np.asarray(pts, dtype=float)
    if arr.ndim <= 1:
        return Coordinate(arr)
    return arr.view(CoordinateArray)


def make_voxel(pts, matrix_indexing: bool = True) -> Union[Voxel, VoxelArray]:
    """A Voxel (1-D input) or a VoxelArray (2-D input)."""
    arr = np.asarray(pts)
    if arr.ndim <= 1:
        return Voxel(arr, matrix_indexing)
    return VoxelArray(arr, matrix_indexing)


def make_voxel_center(pts, matrix_indexing: bool = True) -> Union[VoxelCenter, VoxelCenterArray]:
    """A VoxelCenter (1-D input) or a VoxelCenterArray (2-D input)."""
    arr = np.asarray(pts)
    if arr.ndim <= 1:
        return VoxelCenter(arr, matrix_indexing)
    return VoxelCenterArray(arr, matrix_indexing)


def _need(coordinatesystem):
    if coordinatesystem is None:
        raise ValueError("a coordinate system is needed between physical and voxel space")
    return coordinatesystem


def _convert_point(point, cls, coordinatesystem=None):
    """Conversion between the point flavours."""
    if isinstance(point, Coordinate):
        if cls in (Coordinate, CoordinateArray):
            return point
        if cls in (Voxel, VoxelArray):
            return _need(coordinatesystem).voxel(point)
        if cls in (VoxelCenter, VoxelCenterArray):
            return make_voxel_center(np.asarray(_need(coordinatesystem).voxel(point)))
    elif isinstance(point, VoxelCenter):
        if cls in (VoxelCenter, VoxelCenterArray):
            return point
        if cls in (Voxel, VoxelArray):
            return make_voxel(np.floor(np.asarray(point)))
        if cls in (Coordinate, CoordinateArray):
            return _need(coordinatesystem).coordinate(point)
    elif isinstance(point, Voxel):
        if cls in (Voxel, VoxelArray):
            return point
        if cls in (VoxelCenter, VoxelCenterArray):
            return make_voxel_center(np.asarray(point))
        if cls in (Coordinate, CoordinateArray):
            # A voxel maps to its corner; its center goes through VoxelCenter.
            return _need(coordinatesystem).coordinate(point)
    raise TypeError(f"Cannot convert {type(point)} to {cls}")


def _as_point(point):
    if isinstance(point, BasePoint):
        return point
    arr = np.asarray(point)
    if np.issubdtype(arr.dtype, np.integer):
        return make_voxel(arr)
    return make_coordinate(arr)


def to_coordinate(point, coordinatesystem=None):
    """Any point flavour as Coordinate(s)."""
    return _as_point(point).to(Coordinate, coordinatesystem)


def to_voxel(point, coordinatesystem=None):
    """Any point flavour as Voxel(s)."""
    return _as_point(point).to(Voxel, coordinatesystem)


def to_voxel_center(point, coordinatesystem=None):
    """Any point flavour as VoxelCenter(s)."""
    return _as_point(point).to(VoxelCenter, coordinatesystem)
