"""Geometric point transformations and transformation-based image correction.

Counterpart of :mod:`darsia_tpu.corrections.shape.transformation`.  The point
maps and their fits are host-side float64 numpy, as in the JAX package; the
coordinate field of a correction is built once on the host, cached per device
as float32, and applied with the nearest-voxel gather warp on the image's
device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from ...ops.warp import warp
from ...utils.point import (
    Coordinate,
    CoordinateArray,
    Voxel,
    VoxelArray,
    VoxelCenter,
    VoxelCenterArray,
    make_voxel,
    make_voxel_center,
)
from ..base import BaseCorrection

__all__ = ["BaseTransformation", "TransformationCorrection"]

_ARRAY_TYPE = {
    Coordinate: CoordinateArray,
    Voxel: VoxelArray,
    VoxelCenter: VoxelCenterArray,
    np.ndarray: np.ndarray,
}


class BaseTransformation(ABC):
    """Invertible point map with typed input/output point flavours."""

    def __init__(self) -> None:
        self.input_dtype = np.ndarray
        self.output_dtype = np.ndarray
        self.input_array_dtype = np.ndarray
        self.output_array_dtype = np.ndarray

    def set_dtype(self, pts_src, pts_dst) -> None:
        if pts_src.shape != pts_dst.shape:
            raise ValueError("source and target points must match")
        self.input_dtype = type(pts_src[0])
        self.output_dtype = type(pts_dst[0])
        try:
            self.input_array_dtype = _ARRAY_TYPE[self.input_dtype]
            self.output_array_dtype = _ARRAY_TYPE[self.output_dtype]
        except KeyError as exc:
            raise ValueError("point type not supported") from exc

    @abstractmethod
    def set_parameters_as_vector(self, parameters: np.ndarray) -> None: ...

    @abstractmethod
    def fit(self, pts_src, pts_dst, **kwargs) -> None: ...

    @abstractmethod
    def call_array(self, x: np.ndarray) -> np.ndarray: ...

    @abstractmethod
    def inverse_array(self, x: np.ndarray) -> np.ndarray: ...

    def __call__(self, x):
        x_arr = np.atleast_2d(np.asarray(x))
        array_input = x_arr.shape == np.asarray(x).shape
        out_arr = self.call_array(x_arr)
        if array_input:
            return _wrap(out_arr, self.output_array_dtype)
        return _wrap(out_arr[0], self.output_dtype)

    def inverse(self, x):
        x_arr = np.atleast_2d(np.asarray(x))
        array_input = x_arr.shape == np.asarray(x).shape
        out_arr = self.inverse_array(x_arr)
        if array_input:
            return _wrap(out_arr, self.input_array_dtype)
        return _wrap(out_arr[0], self.input_dtype)


def _wrap(arr: np.ndarray, cls):
    if cls is np.ndarray:
        return arr
    if cls in (Voxel, VoxelArray):
        return make_voxel(arr)
    if cls in (VoxelCenter, VoxelCenterArray):
        return make_voxel_center(arr)
    return np.asarray(arr, dtype=float).view(cls)


class TransformationCorrection(BaseCorrection):
    """Warp an image from a source to a destination coordinate system by an
    invertible point transformation (nearest-voxel assignment)."""

    def __init__(
        self,
        coordinatesystem_src,
        coordinatesystem_dst,
        transformation: BaseTransformation,
    ) -> None:
        self.coordinatesystem_src = coordinatesystem_src
        self.coordinatesystem_dst = coordinatesystem_dst
        self.transformation = transformation
        self._cache: dict = {}

    def pullback_coordinates(self) -> np.ndarray:
        """The source voxel position of every destination voxel, ``(dim,
        *dst_shape)`` float64, through the inverse transformation (host)."""
        # The transformation's input: voxel centers, in its point flavour.
        transformation_input = make_voxel_center(
            np.asarray(self.coordinatesystem_dst.voxels)
        ).to(self.transformation.input_dtype, self.coordinatesystem_dst)
        transformation_output = self.transformation.inverse(transformation_input)
        # Back to (continuous) source voxels.
        if isinstance(transformation_output, (Coordinate, CoordinateArray)):
            voxels_src = np.asarray(
                self.coordinatesystem_src.voxel(transformation_output), dtype=float
            )
        else:
            voxels_src = np.asarray(transformation_output, dtype=float)
        dst_shape = self.coordinatesystem_dst.shape
        dim = self.coordinatesystem_src.dim
        return np.moveaxis(voxels_src.reshape((*dst_shape, dim), order="F"), -1, 0)

    def _coords(self, device) -> torch.Tensor:
        """The float32 coordinate field on ``device``, built on first use."""
        if "coords" not in self._cache:
            coords = np.ascontiguousarray(self.pullback_coordinates(), dtype=np.float32)
            self._cache["coords"] = torch.from_numpy(coords)
        key = ("coords", str(device))
        if key not in self._cache:
            self._cache[key] = self._cache["coords"].to(device)
        return self._cache[key]

    def correct_array(self, array_src: torch.Tensor) -> torch.Tensor:
        dtype = array_src.dtype
        out = warp(array_src.to(torch.float32), self._coords(array_src.device), order=0)
        if not dtype.is_floating_point:
            out = torch.round(out)
        return out.to(dtype)

    def save(self, path) -> None:
        raise NotImplementedError("Not implemented yet.")

    def load(self, path) -> None:
        raise NotImplementedError("Not implemented yet.")
