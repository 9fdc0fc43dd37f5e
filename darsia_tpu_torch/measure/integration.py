"""Geometric integration over (weighted / extruded / porous) geometries.

Counterpart of :mod:`darsia_tpu.measure.integration`.  The voxel volumes are
host-side numpy, as there; the weighted sum runs on the data's device (a
tensor or an Image stays where it is, a numpy array goes to ``device``, the
CUDA card by default), accumulates in float64 and comes back as a float or a
numpy array.  On the CPU it is the JAX package's numpy reduction, in its
order, so the two packages' integrals of equal data are bitwise equal (a
calibration that compares integrals then takes the same path in both).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Union

import numpy as np
import torch

from ..image.coordinatesystem import CoordinateSystem
from ..image.image import (
    ExtensiveImage,
    Image,
    _default_origin,
    as_numpy,
    as_tensor,
    voxel_box,
)
from ..ops.resize import resize_array

__all__ = [
    "ExtrudedGeometry",
    "ExtrudedPorousGeometry",
    "Geometry",
    "PorousGeometry",
    "WeightedGeometry",
]


def _host_array(data):
    """An Image's or tensor's data as numpy; anything else as it is."""
    data = data.img if hasattr(data, "img") else data
    return as_numpy(data) if isinstance(data, torch.Tensor) else data


def _copy_volume(volume):
    return volume.copy() if isinstance(volume, np.ndarray) else volume


class Geometry:
    """Geometry of a voxelized domain with integration capabilities."""

    def __init__(
        self,
        space_dim: int,
        num_voxels,
        dimensions: Optional[list] = None,
        voxel_size: Optional[list] = None,
        **kwargs,
    ) -> None:
        self.space_dim = space_dim
        self.num_voxels = list(num_voxels[:space_dim])
        if dimensions is None:
            if voxel_size is None:
                raise ValueError("give dimensions or voxel_size")
            self.voxel_size = list(voxel_size)
            self.dimensions = [
                self.num_voxels[i] * self.voxel_size[i] for i in range(self.space_dim)
            ]
        else:
            self.dimensions = list(dimensions)
            self.voxel_size = [
                self.dimensions[i] / self.num_voxels[i] for i in range(self.space_dim)
            ]
        self.voxel_volume = np.prod(self.voxel_size)
        self.cached_voxel_volume = _copy_volume(self.voxel_volume)
        self._on_device = None

    def _prepare_cached_voxel_volume(self, fetched_shape: list, device) -> None:
        """Fit the cached voxel volume to data of another (2-D) shape; a map
        is resized on ``device``, where the data lies."""
        scaling = float(np.prod(np.divide(self.num_voxels, fetched_shape)))
        if isinstance(self.voxel_volume, np.ndarray):
            cached_shape = list(np.shape(self.cached_voxel_volume))
            if fetched_shape != cached_shape:
                if self.space_dim != 2:
                    raise ValueError("Reshaping only supported in 2d.")
                resized = resize_array(
                    torch.from_numpy(self.voxel_volume.astype(np.float32)).to(device),
                    tuple(fetched_shape[:2]),
                    "inter_area",
                )
                self.cached_voxel_volume = as_numpy(resized) * scaling
        elif fetched_shape == self.num_voxels:
            self.cached_voxel_volume = self.voxel_volume
        else:
            if self.space_dim != 2:
                raise ValueError("Reshaping only supported in 2d.")
            self.cached_voxel_volume = self.voxel_volume * scaling

    def _volume_for(self, fetched: torch.Tensor):
        """The cached voxel volume, fit to ``fetched``: a float, or a float64
        tensor on its device broadcast over the range axes (kept until the
        cached volume or the device changes)."""
        self._prepare_cached_voxel_volume(
            list(fetched.shape[: self.space_dim]), fetched.device
        )
        volume = self.cached_voxel_volume
        if not isinstance(volume, np.ndarray):
            return float(volume)
        held = self._on_device
        if held is None or held[0] is not volume or held[1].device != fetched.device:
            tensor = torch.from_numpy(np.asarray(volume, dtype=np.float64)).to(fetched.device)
            held = self._on_device = (volume, tensor)
        return held[1].reshape(held[1].shape + (1,) * (fetched.dim() - self.space_dim))

    def integrate(self, data, device=None) -> Union[float, np.ndarray]:
        """Integrate data (an Image, a tensor or a numpy array) over the
        geometry: the sum over the space axes of voxel volume times value, of
        the values alone for an :class:`ExtensiveImage`.  A numpy array goes
        to ``device`` (the CUDA card by default) and is integrated there; CPU
        data is summed in the JAX package's order."""
        fetched = as_tensor(data.img if hasattr(data, "img") else data, device)
        if fetched.device.type == "cpu":
            return self._integrate_on_host(data, fetched.contiguous().numpy())
        axes = tuple(range(self.space_dim))
        if isinstance(data, ExtensiveImage):
            total = torch.sum(fetched, dim=axes)
        else:
            volume = self._volume_for(fetched)
            if isinstance(volume, float):
                total = torch.sum(fetched, dim=axes, dtype=torch.float64) * volume
            else:
                total = torch.sum(volume * fetched, dim=axes)
        return total.item() if total.dim() == 0 else as_numpy(total)

    def _integrate_on_host(self, data, fetched: np.ndarray) -> Union[float, np.ndarray]:
        """``integrate`` of CPU data: the JAX package's numpy reduction in its
        order (the float64 products summed axis by axis), so the port's sums
        on the CPU are bitwise the JAX package's."""
        total = fetched
        if not isinstance(data, ExtensiveImage):
            self._prepare_cached_voxel_volume(list(fetched.shape[: self.space_dim]), "cpu")
            volume = self.cached_voxel_volume
            if isinstance(volume, np.ndarray) and fetched.ndim > self.space_dim:
                volume = volume.reshape(volume.shape + (1,) * (fetched.ndim - self.space_dim))
            total = np.multiply(volume, fetched)
        for _ in range(self.space_dim):
            total = np.sum(total, axis=0)
        return float(total) if np.ndim(total) == 0 else total

    def make_extensive(self, data: Image) -> ExtensiveImage:
        """Convert intensive data to per-voxel integrated (extensive) data."""
        fetched = data.img
        product = self._volume_for(fetched) * fetched.to(torch.float64)
        return ExtensiveImage(product.to(torch.float32), **data.metadata())

    def normalize(self, img: Image, img_ref: Image, return_ratio: bool = False):
        """Rescale ``img`` so its integral matches ``img_ref``'s."""
        ratio = np.divide(self.integrate(img_ref), self.integrate(img))
        rescaled = img.copy()
        if np.ndim(ratio) == 0:
            rescaled.img = img.img * float(ratio)
        else:
            rescaled.img = img.img * torch.from_numpy(ratio).to(img.device, torch.float32)
        if return_ratio:
            return rescaled, ratio
        return rescaled

    def subregion(self, roi) -> "Geometry":
        """The flat geometry of the box spanned by the points ``roi``."""
        roi = np.asarray(roi)
        new_dimensions = []
        new_num_voxels = []
        for i in range(self.space_dim):
            length = float(np.max(roi, axis=0)[i] - np.min(roi, axis=0)[i])
            new_dimensions.append(length)
            new_num_voxels.append(int(np.ceil(length / self.voxel_size[i])))
        return Geometry(self.space_dim, new_num_voxels, new_dimensions)


class WeightedGeometry(Geometry):
    """Geometry with a (possibly heterogeneous) volume weight: a scalar, a
    numpy array, a tensor or an Image over the space axes."""

    def __init__(
        self,
        weight,
        space_dim: int,
        num_voxels,
        dimensions: Optional[list] = None,
        voxel_size: Optional[list] = None,
        **kwargs,
    ) -> None:
        super().__init__(space_dim, num_voxels, dimensions, voxel_size)
        weight = _host_array(weight)
        if isinstance(weight, np.ndarray) and weight.ndim != self.space_dim:
            raise ValueError(
                "Weight must have the same number of dimensions as the geometry."
            )
        self.weight = (
            np.nan_to_num(np.array(weight, copy=True), nan=0.0)
            if isinstance(weight, np.ndarray)
            else weight
        )
        self._set_voxel_volume(np.multiply(self.voxel_volume, self.weight))

    def _set_voxel_volume(self, volume) -> None:
        self.voxel_volume = volume
        self.cached_voxel_volume = _copy_volume(volume)

    def subregion(self, roi) -> "WeightedGeometry":
        sub = super().subregion(roi)
        if isinstance(self.weight, np.ndarray):
            # The weight map is host-side; its box is cut as Image.subregion
            # cuts an image of this geometry at the default origin.
            indexing = "ijk"[: self.space_dim]
            grid = SimpleNamespace(
                indexing=indexing,
                space_dim=self.space_dim,
                num_voxels=self.num_voxels,
                dimensions=self.dimensions,
                voxel_size=self.voxel_size,
                origin=_default_origin(self.space_dim, indexing, self.dimensions),
            )
            sub_weight = self.weight[voxel_box(roi, CoordinateSystem(grid))]
            num_voxels = list(sub_weight.shape)
        else:
            sub_weight = self.weight
            num_voxels = sub.num_voxels
        return WeightedGeometry(
            sub_weight, sub.space_dim, num_voxels, sub.dimensions, sub.voxel_size
        )


class ExtrudedGeometry(WeightedGeometry):
    """2-D geometry extruded by an effective depth (a scalar or a map)."""

    def __init__(
        self, expansion, space_dim, num_voxels, dimensions=None, voxel_size=None, **kwargs
    ):
        self.depth = _host_array(expansion)
        super().__init__(self.depth, space_dim, num_voxels, dimensions, voxel_size)


class PorousGeometry(WeightedGeometry):
    """Geometry weighted by porosity."""

    def __init__(
        self, porosity, space_dim, num_voxels, dimensions=None, voxel_size=None, **kwargs
    ):
        self.porosity = porosity
        super().__init__(porosity, space_dim, num_voxels, dimensions, voxel_size)


class ExtrudedPorousGeometry(WeightedGeometry):
    """Geometry weighted by porosity * depth."""

    def __init__(
        self,
        porosity,
        depth,
        space_dim,
        num_voxels,
        dimensions=None,
        voxel_size=None,
        **kwargs,
    ):
        self.porosity = porosity
        self.depth = depth
        integrated = np.multiply(_host_array(porosity), _host_array(depth))
        super().__init__(integrated, space_dim, num_voxels, dimensions, voxel_size)

    def update(self, depth) -> None:
        """Update the effective depth and recompute the weighted volumes."""
        self.depth = depth
        integrated = np.multiply(_host_array(self.porosity), _host_array(depth))
        self._set_voxel_volume(
            np.multiply(np.divide(self.voxel_volume, self.weight), integrated)
        )
        self.weight = integrated
