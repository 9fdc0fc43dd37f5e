"""Physical images: a tensor plus metadata.

Counterpart of :mod:`darsia_tpu.image.image` for 2-D images, single frames
or time series.  ``Image.img`` is a ``torch.Tensor``: a tensor input stays on
its device, a numpy input goes to ``device`` (the CUDA card unless the
caller asks for another, e.g. ``device="cpu"``).  The metadata (physical
dimensions in meters, Cartesian origin, dates and times) stays on the host.
Corrections passed as ``transformations=[...]`` run at construction, runs of
geometric ones fused into one warp
(:func:`darsia_tpu_torch.corrections.fuse.apply_transformation_chain`).
"""

from __future__ import annotations

from typing import Optional
from warnings import warn

import numpy as np
import torch

from ..utils.dtype import convert_dtype
from .coordinatesystem import CoordinateSystem

__all__ = ["Image", "OpticalImage", "ScalarImage", "as_tensor"]


def as_tensor(array, device=None) -> torch.Tensor:
    """``array`` as a tensor: a tensor stays where it is (or moves to
    ``device`` when one is given); a numpy array goes to ``device``, which is
    the CUDA card when None.

    Raises:
        RuntimeError: a numpy array, no ``device`` and no CUDA card.

    """
    if isinstance(array, torch.Tensor):
        return array if device is None else array.to(device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for a numpy input: pass device=\"cpu\" to run on "
                "the CPU"
            )
        device = "cuda"
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _is_none(value) -> bool:
    if isinstance(value, list):
        return all(v is None for v in value)
    return value is None


class Image:
    """Physical 2-D image: ``(H, W[, T][, C])``, matrix indexing, the time
    axis (series only) after the space axes.

    Args:
        img: tensor or numpy array.
        transformations: corrections applied in order at construction
            (single frames only).
        device: where a numpy ``img`` goes (default: the CUDA card); a tensor
            moves there only when it is given.
        **kwargs: metadata: ``dimensions`` (or ``height``/``width``),
            ``origin``, ``series``, ``scalar``, ``date``, ``reference_date``,
            ``time``, ``name``.

    """

    def __init__(
        self, img, transformations: Optional[list] = None, device=None, **kwargs
    ) -> None:
        self.img = as_tensor(img, device)

        self.space_dim = int(kwargs.get("space_dim", kwargs.get("dim", 2)))
        self.indexing = kwargs.get("indexing", "ij")
        if self.space_dim != 2 or self.indexing != "ij":
            raise NotImplementedError("only 2-D matrix-indexed images are ported")

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

        self.series = bool(kwargs.get("series", False))
        self.time_dim = int(self.series)
        self.time_num = int(self.img.shape[self.space_dim]) if self.series else 1
        self.date = kwargs.get("date", self.time_num * [None] if self.series else None)
        self.reference_date = kwargs.get(
            "reference_date", self.date[0] if isinstance(self.date, list) else self.date
        )
        self.set_time(kwargs.get("time"))
        if self.series and _is_none(self.date) and _is_none(self.time):
            warn("No time information provided for the image.")

        self.scalar = bool(kwargs.get("scalar", False))
        lead = self.space_dim + self.time_dim
        self.range_dim = 0 if self.scalar else self.img.dim() - lead
        if self.img.dim() != lead + self.range_dim:
            raise ValueError(f"image of shape {self.shape} does not fit its metadata")

        if transformations is not None:
            if self.series:
                raise NotImplementedError("corrections of a series are not ported yet")
            from ..corrections.fuse import apply_transformation_chain

            apply_transformation_chain(self, transformations)

    def set_time(self, time=None) -> None:
        """Set the relative time (seconds); from the dates when not given."""
        if time is not None:
            self.time = time
        elif _is_none(self.date) or self.reference_date is None:
            self.time = self.time_num * [None] if self.series else None
        elif self.series:
            self.time = [(d - self.reference_date).total_seconds() for d in self.date]
        else:
            self.time = (self.date - self.reference_date).total_seconds()

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

    def time_slice(self, time_index: int) -> "Image":
        """Single frame ``time_index`` of a series (a view of its tensor)."""
        if not self.series:
            raise ValueError("Image is not a time-series.")
        img = self.img[..., time_index] if self.scalar else self.img[..., time_index, :]
        metadata = self.metadata()
        metadata["series"] = False
        metadata["date"] = None if self.date is None else self.date[time_index]
        metadata["time"] = None if self.time is None else self.time[time_index]
        return type(self)(img=img, **metadata)

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

    def __init__(self, img, transformations=None, device=None, **kwargs):
        kwargs["scalar"] = True
        super().__init__(img, transformations, device, **kwargs)


class OpticalImage(Image):
    """Trichromatic photograph (RGB range axis)."""

    def __init__(self, img, transformations=None, device=None, **kwargs):
        kwargs["scalar"] = False
        kwargs["space_dim"] = 2
        self.color_space = str(kwargs.pop("color_space", "RGB")).upper()
        super().__init__(img, transformations, device, **kwargs)

    def metadata(self) -> dict:
        meta = super().metadata()
        meta["color_space"] = self.color_space
        return meta
