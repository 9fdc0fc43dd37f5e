"""Physical images: a tensor plus metadata.

Counterpart of :mod:`darsia_tpu.image.image` for single (non-series) 2-D
images.  ``Image.img`` is a ``torch.Tensor`` on whatever device it was given
(numpy input lands on the CPU); the metadata (physical dimensions in meters,
Cartesian origin, time) stays on the host.  Corrections passed as
``transformations=[...]`` run at construction, runs of geometric ones fused
into one warp (:func:`darsia_tpu_torch.corrections.fuse.apply_transformation_chain`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.dtype import convert_dtype
from .coordinatesystem import CoordinateSystem

__all__ = ["Image", "OpticalImage", "ScalarImage"]


def _as_tensor(img) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.ascontiguousarray(img))


class Image:
    """Physical 2-D image (``(H, W[, C])``, matrix indexing).

    Args:
        img: tensor or numpy array.
        transformations: corrections applied in order at construction.
        **kwargs: metadata: ``dimensions`` (or ``height``/``width``),
            ``origin``, ``scalar``, ``date``, ``time``, ``name``.

    """

    def __init__(self, img, transformations: Optional[list] = None, **kwargs) -> None:
        self.img = _as_tensor(img)

        self.space_dim = int(kwargs.get("space_dim", kwargs.get("dim", 2)))
        self.indexing = kwargs.get("indexing", "ij")
        if self.space_dim != 2 or self.indexing != "ij":
            raise NotImplementedError("only 2-D matrix-indexed images are ported")
        if kwargs.get("series", False):
            raise NotImplementedError("time series are not ported yet")
        self.series = False

        dimensions = list(kwargs.get("dimensions", [1.0, 1.0]))
        if "height" in kwargs:
            dimensions[0] = kwargs["height"]
        if "width" in kwargs:
            dimensions[1] = kwargs["width"]
        self.dimensions = [float(d) for d in dimensions]
        # Cartesian coordinate of voxel (0, 0): y runs against rows, so the
        # default origin sits at (0, height).
        self.origin = np.asarray(
            kwargs.get("origin", [0.0, self.dimensions[0]]), dtype=float
        )
        self.name = kwargs.get("name")
        self.date = kwargs.get("date")
        self.reference_date = kwargs.get("reference_date", self.date)
        self.time = kwargs.get("time")

        self.scalar = bool(kwargs.get("scalar", False))
        self.range_dim = 0 if self.scalar else self.img.dim() - self.space_dim
        if self.img.dim() != self.space_dim + self.range_dim:
            raise ValueError(f"image of shape {self.shape} does not fit its metadata")

        if transformations is not None:
            from ..corrections.fuse import apply_transformation_chain

            apply_transformation_chain(self, transformations)

    # ------------------------------------------------------------------ data

    @property
    def shape(self) -> tuple:
        return tuple(self.img.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.img.dtype

    @property
    def device(self) -> torch.device:
        return self.img.device

    @property
    def num_voxels(self) -> list:
        return list(self.shape[: self.space_dim])

    @property
    def voxel_size(self) -> list:
        return [self.dimensions[i] / self.num_voxels[i] for i in range(self.space_dim)]

    @property
    def coordinatesystem(self) -> CoordinateSystem:
        return CoordinateSystem(self)

    # -------------------------------------------------------------- metadata

    def metadata(self) -> dict:
        """Metadata dictionary, sufficient to reconstruct the image."""
        return {
            "space_dim": self.space_dim,
            "indexing": self.indexing,
            "dimensions": list(self.dimensions),
            "origin": self.origin.copy(),
            "series": self.series,
            "scalar": self.scalar,
            "date": self.date,
            "reference_date": self.reference_date,
            "time": self.time,
            "name": self.name,
        }

    def copy(self) -> "Image":
        """Copy of the image; the tensor is cloned."""
        return type(self)(img=self.img.clone(), **self.metadata())

    def img_as(self, data_type) -> "Image":
        """Image with data converted (and range-rescaled) to ``data_type``.

        The tensor is shared, not copied, when it already has that dtype.
        """
        return type(self)(img=convert_dtype(self.img, data_type), **self.metadata())


class ScalarImage(Image):
    """Scalar-valued image (no range axes)."""

    def __init__(self, img, transformations=None, **kwargs):
        kwargs["scalar"] = True
        super().__init__(img, transformations, **kwargs)


class OpticalImage(Image):
    """Trichromatic photograph (RGB range axis)."""

    def __init__(self, img, transformations=None, **kwargs):
        kwargs["scalar"] = False
        kwargs["space_dim"] = 2
        self.color_space = str(kwargs.pop("color_space", "RGB")).upper()
        super().__init__(img, transformations, **kwargs)

    def metadata(self) -> dict:
        meta = super().metadata()
        meta["color_space"] = self.color_space
        return meta
