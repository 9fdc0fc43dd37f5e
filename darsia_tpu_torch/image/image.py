"""Physical images: a tensor plus metadata.

Counterpart of :mod:`darsia_tpu.image.image` for 2-D images, single frames
or time series.  ``Image.img`` is a ``torch.Tensor``: a tensor input stays on
its device, a numpy input goes to ``device`` (the CUDA card unless the
caller asks for another, e.g. ``device="cpu"``).  The metadata (physical
dimensions in meters, Cartesian origin, dates and times) stays on the host.
Corrections passed as ``transformations=[...]`` run at construction, runs of
geometric ones fused into one warp
(:func:`darsia_tpu_torch.corrections.fuse.apply_transformation_chain`); a
series is corrected frame for frame with the same correction.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union
from warnings import warn

import numpy as np
import torch

from ..utils.dtype import convert_dtype
from ..utils.point import CoordinateArray, VoxelArray
from .coordinatesystem import CoordinateSystem

__all__ = ["Image", "OpticalImage", "ScalarImage", "as_numpy", "as_tensor"]


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


def as_numpy(array) -> np.ndarray:
    """``array`` (a tensor on any device, or array-like) as a host numpy array."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def _is_none(value) -> bool:
    if isinstance(value, list):
        return all(v is None for v in value)
    return value is None


class Image:
    """Physical 2-D image: ``(H, W[, T][, C])``, matrix indexing, the time
    axis (series only) after the space axes.

    Args:
        img: tensor or numpy array.
        transformations: corrections applied in order at construction (to
            every frame of a series).
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

    def shape_metadata(self) -> dict:
        """The spatial part of the metadata, with shape and voxel size."""
        return {
            "space_dim": self.space_dim,
            "indexing": self.indexing,
            "dimensions": list(self.dimensions),
            "origin": self.origin.copy(),
            "shape": self.shape,
            "num_voxels": self.num_voxels,
            "voxel_size": self.voxel_size,
        }

    def update_metadata(self, meta: Optional[dict] = None, **kwargs) -> None:
        """Overwrite metadata attributes in place."""
        for key, value in {**(meta or {}), **kwargs}.items():
            setattr(self, key, value)

    # ------------------------------------------------------------------ time

    def append(self, image: "Image", offset=None) -> None:
        """Append another image (a frame or a series) along the time axis,
        making this image a series.  The stacked tensor is new: neither
        image's tensor is aliased."""
        if self.space_dim != image.space_dim or self.scalar != image.scalar:
            raise ValueError("Incompatible images for append.")
        if self.num_voxels != image.num_voxels or not np.allclose(
            self.dimensions, image.dimensions
        ):
            raise ValueError("Incompatible voxel grids for append.")
        if not np.allclose(self.origin, image.origin):
            raise ValueError("Incompatible origins for append.")

        def frames(im: "Image") -> list:
            data = im.img.to(self.img.device)
            return list(data.unbind(self.space_dim)) if im.series else [data]

        self.img = torch.stack(frames(self) + frames(image), dim=self.space_dim)
        self.series = True
        self.time_dim = 1
        as_list = lambda v: v if isinstance(v, list) else [v]  # noqa: E731
        self.date = as_list(self.date) + as_list(image.date)
        if _is_none(self.time) or _is_none(image.time) or offset is None:
            time = None
        else:
            time = as_list(self.time) + [t + offset for t in as_list(image.time)]
        self.time_num += image.time_num
        self.set_time(time)

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

    def time_interval(self, indices: slice) -> "Image":
        """The frames ``indices`` of a series (a view of its tensor)."""
        if not self.series:
            raise ValueError("Image is not a time-series.")
        if not isinstance(indices, slice):
            raise ValueError("indices needs to be a slice")
        img = self.img[..., indices] if self.scalar else self.img[..., indices, :]
        metadata = self.metadata()
        metadata["date"] = None if self.date is None else self.date[indices]
        metadata["time"] = None if self.time is None else self.time[indices]
        return type(self)(img=img, **metadata)

    # ----------------------------------------------------------------- space

    def subregion(self, roi: Union[tuple, VoxelArray, CoordinateArray]) -> "Image":
        """A box of the image (a view of its tensor), with its own origin and
        dimensions.

        Args:
            roi: a tuple of voxel slices, a VoxelArray, or a CoordinateArray of
                Cartesian points spanning the box.

        """
        if isinstance(roi, (CoordinateArray, VoxelArray)):
            if isinstance(roi, CoordinateArray):
                roi = self.coordinatesystem.voxel(roi)
            box = np.asarray(roi)
            voxels = tuple(
                slice(max(0, int(box[:, d].min())), min(int(box[:, d].max()), n))
                for d, n in enumerate(self.num_voxels)
            )
        elif isinstance(roi, tuple):
            voxels = roi
        else:
            raise ValueError(
                f"roi of type {type(roi)} not supported; need tuple of slices, "
                "VoxelArray, or CoordinateArray."
            )
        if len(voxels) != self.space_dim:
            raise ValueError(f"roi {voxels} does not span {self.space_dim} axes")
        cs = self.coordinatesystem
        sizes = self.num_voxels
        origin = cs.coordinate([0 if sl.start is None else sl.start for sl in voxels])
        opposite = cs.coordinate(
            [n if sl.stop is None else sl.stop for sl, n in zip(voxels, sizes)]
        )
        extent = np.abs(np.asarray(opposite) - np.asarray(origin))
        metadata = self.metadata()
        # Matrix axis i is Cartesian y, axis j is x.
        metadata["dimensions"] = [float(extent[1]), float(extent[0])]
        metadata["origin"] = np.asarray(origin)
        return type(self)(img=self.img[voxels], **metadata)

    # ------------------------------------------------------------------ data

    def copy(self) -> "Image":
        """Copy of the image; the tensor is cloned."""
        return type(self)(img=self.img.clone(), **self.metadata())

    def astype(self, data_type) -> "Image":
        """Image with data converted (and range-rescaled) to ``data_type``.

        The tensor is shared, not copied, when it already has that dtype.
        """
        return type(self)(img=convert_dtype(self.img, data_type), **self.metadata())

    img_as = astype

    # ------------------------------------------------------------------- I/O

    def save(self, path: Union[str, Path]) -> None:
        """Persist the image (array + metadata) as a compressed npz, which
        ``imread`` of this package and of the JAX package read: every
        metadata value is a plain numpy or Python value."""
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            array=as_numpy(self.img),
            metadata=np.array([self.metadata()], dtype=object),
            image_class=type(self).__name__,
        )

    # ------------------------------------------------------------ arithmetic
    # Each result holds a new tensor; the operands' tensors are not aliased.

    def _compatible(self, other: "Image") -> bool:
        return (
            self.shape == other.shape
            and np.allclose(self.origin, other.origin)
            and np.allclose(self.dimensions, other.dimensions)
        )

    def _with(self, img: torch.Tensor) -> "Image":
        return type(self)(img=img, **self.metadata())

    def _operand(self, other, check: bool = True):
        if isinstance(other, Image):
            if check and not self._compatible(other):
                raise ValueError("Images not compatible.")
            return other.img
        return other

    def __add__(self, other):
        return self._with(self.img + self._operand(other))

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self.copy()
        return self.__add__(other)

    def __sub__(self, other):
        return self._with(self.img - self._operand(other))

    def __mul__(self, other):
        return self._with(self.img * self._operand(other, check=False))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._with(self.img / self._operand(other, check=False))

    def __neg__(self):
        return self._with(-self.img)


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

    def to_trichromatic(self, color_space: str, return_image: bool = False):
        """Convert from the current colour space to ``color_space`` (RGB,
        BGR, HSV, HLS, LAB): in place, or into a new image with
        ``return_image``."""
        from ..ops.color import convert_trichromatic

        color_space = color_space.upper()
        if color_space == self.color_space:
            return self.copy() if return_image else None
        converted = convert_trichromatic(self.img, self.color_space, color_space)
        if return_image:
            image = self._with(converted)
            image.color_space = color_space
            return image
        self.img = converted
        self.color_space = color_space
        return None

    def to_monochromatic(self, key: str) -> ScalarImage:
        """Scalar image of one channel or feature: gray, red, green, blue,
        hue, saturation, value or norm."""
        from ..ops.color import convert_trichromatic, to_monochromatic

        data = self.img
        if self.color_space != "RGB":
            data = convert_trichromatic(data, self.color_space, "RGB")
        metadata = self.metadata()
        metadata.pop("scalar", None)
        metadata["name"] = key
        return ScalarImage(to_monochromatic(data, key), **metadata)
