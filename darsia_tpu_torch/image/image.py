"""Physical images: a tensor plus metadata.

Counterpart of :mod:`darsia_tpu.image.image`: 1-, 2- and 3-D images, single
frames or time series.  ``Image.img`` is a ``torch.Tensor``: a tensor input stays on
its device, a numpy input goes to ``device`` (the CUDA card unless the
caller asks for another, e.g. ``device="cpu"``).  The metadata (physical
dimensions in meters, Cartesian origin, dates and times) stays on the host.
Corrections passed as ``transformations=[...]`` run at construction, runs of
geometric ones fused into one warp
(:func:`darsia_tpu_torch.corrections.fuse.apply_transformation_chain`); a
series is corrected frame for frame with the same correction.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Optional, Union
from warnings import warn

import numpy as np
import torch

from ..utils.dtype import convert_dtype
from ..utils.point import Coordinate, CoordinateArray, Voxel, VoxelArray
from .coordinatesystem import CoordinateSystem
from .indexing import interpret_indexing

__all__ = [
    "ExtensiveImage",
    "Image",
    "OpticalImage",
    "ScalarImage",
    "as_numpy",
    "as_tensor",
]


def card_unless(device=None, what: str = "a numpy input") -> torch.device:
    """``device``, or the CUDA card when it is None.

    Raises:
        RuntimeError: no ``device`` and no CUDA card (naming ``what``).

    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device for {what}: pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def as_tensor(array, device=None) -> torch.Tensor:
    """``array`` as a tensor: a tensor stays where it is (or moves to
    ``device`` when one is given); a numpy array goes to ``device``, which is
    the CUDA card when None.

    Raises:
        RuntimeError: a numpy array, no ``device`` and no CUDA card.

    """
    if isinstance(array, torch.Tensor):
        return array if device is None else array.to(device)
    return torch.from_numpy(np.ascontiguousarray(array)).to(card_unless(device))


def as_numpy(array) -> np.ndarray:
    """``array`` (a tensor on any device, or array-like) as a host numpy array."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def voxel_box(roi, coordinatesystem) -> tuple:
    """The box ``roi`` spans as a tuple of voxel slices, one per space axis:
    ``roi`` is such a tuple already, a VoxelArray, or a CoordinateArray of
    Cartesian points (clipped to the image)."""
    if isinstance(roi, (CoordinateArray, VoxelArray)):
        if isinstance(roi, CoordinateArray):
            roi = coordinatesystem.voxel(roi)
        box = np.asarray(roi)
        voxels = tuple(
            slice(max(0, int(box[:, d].min())), min(int(box[:, d].max()), n))
            for d, n in enumerate(coordinatesystem.shape)
        )
    elif isinstance(roi, tuple):
        voxels = roi
    else:
        raise ValueError(
            f"roi of type {type(roi)} not supported; need tuple of slices, "
            "VoxelArray, or CoordinateArray."
        )
    if len(voxels) != coordinatesystem.dim:
        raise ValueError(f"roi {voxels} does not span {coordinatesystem.dim} axes")
    return voxels


def _is_none(value) -> bool:
    if isinstance(value, list):
        return all(v is None for v in value)
    return value is None


def _default_origin(space_dim: int, indexing: str, dimensions: list) -> list:
    """The origin that lets the reversed axes (y in 2-D; y and z in 3-D) span
    [0, dimension]."""
    origin = space_dim * [0.0]
    for counter, index in enumerate(indexing):
        axis_pos, reverse_axis = interpret_indexing(index, "xyz"[:space_dim])
        if reverse_axis:
            origin[axis_pos] = dimensions[counter]
    return origin


def _absent(what: str, library: str):
    return NotImplementedError(
        f"{what} is not ported: it needs {library}, which is not a dependency of "
        "this package; copy the data to the host (as_numpy) and plot or encode "
        "it there"
    )


class Image:
    """Physical image: space axes (1 to 3, matrix indexing), then the time
    axis (series only), then range axes, e.g. ``(H, W[, T][, C])``.

    Args:
        img: tensor or numpy array.
        transformations: corrections applied in order at construction (to
            every frame of a series).
        device: where a numpy ``img`` goes (default: the CUDA card); a tensor
            moves there only when it is given.
        **kwargs: metadata: ``space_dim``, ``dimensions`` (or ``height``/
            ``width``/``depth`` for axes 0/1/2), ``origin``, ``series``,
            ``scalar``, ``date``, ``reference_date``, ``time``, ``name``.

    """

    def __init__(
        self, img, transformations: Optional[list] = None, device=None, **kwargs
    ) -> None:
        self.img = as_tensor(img, device)

        self.space_dim = int(kwargs.get("space_dim", kwargs.get("dim", 2)))
        if self.space_dim not in (1, 2, 3):
            raise ValueError(f"space_dim {self.space_dim} not supported")
        self.indexing = kwargs.get("indexing", "ijk"[: self.space_dim])
        if self.indexing != "ijk"[: self.space_dim]:
            raise ValueError("matrix indexing only")

        dimensions = list(kwargs.get("dimensions", self.space_dim * [1.0]))
        if "height" in kwargs:
            dimensions[0] = kwargs["height"]
        if "width" in kwargs:
            dimensions[1] = kwargs["width"]
        if "depth" in kwargs and self.space_dim > 2:
            dimensions[2] = kwargs["depth"]
        self.dimensions = [float(d) for d in dimensions]
        # Cartesian coordinate of voxel (0, ..., 0).
        default_origin = _default_origin(self.space_dim, self.indexing, self.dimensions)
        self.origin = np.asarray(kwargs.get("origin", default_origin), dtype=float)
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
    def space_num(self) -> int:
        return int(np.prod(self.shape[: self.space_dim], dtype=int))

    @property
    def num_voxels(self) -> list:
        return list(self.shape[: self.space_dim])

    @property
    def voxel_size(self) -> list:
        return [self.dimensions[i] / self.num_voxels[i] for i in range(self.space_dim)]

    @property
    def coordinatesystem(self) -> CoordinateSystem:
        return CoordinateSystem(self)

    @property
    def opposite_corner(self) -> Coordinate:
        """Cartesian coordinate of the corner opposite to the origin."""
        return self.coordinatesystem.coordinate(self.num_voxels)

    @property
    def domain(self) -> tuple:
        """(xmin, xmax) in 1-D, (xmin, xmax, ymin, ymax) in 2-D."""
        if self.space_dim == 1:
            return (self.origin[0], self.opposite_corner[0])
        if self.space_dim == 2:
            opposite = self.opposite_corner
            return (self.origin[0], opposite[0], opposite[1], self.origin[1])
        raise NotImplementedError

    def as_numpy(self) -> np.ndarray:
        """Host copy of the data."""
        return as_numpy(self.img)

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

    def update_reference_time(self, reference) -> None:
        """Redefine the reference: a datetime (times follow from the dates)
        or a shift in seconds of the relative times."""
        if isinstance(reference, datetime):
            self.reference_date = reference
            self.set_time()
        else:
            delta = float(reference)
            if self.series:
                self.time = [None if t is None else t - delta for t in self.time]
            elif self.time is not None:
                self.time = self.time - delta

    def reset_reference_time(self) -> None:
        """Make the first slice's date (without dates: its time) the reference."""
        if _is_none(self.date):
            if isinstance(self.time, list) and self.time and self.time[0] is not None:
                base = self.time[0]
                self.time = [None if t is None else t - base for t in self.time]
        else:
            self.reference_date = self.date[0] if isinstance(self.date, list) else self.date
            self.set_time()

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
        cs = self.coordinatesystem
        voxels = voxel_box(roi, cs)
        sizes = self.num_voxels
        origin = cs.coordinate([0 if sl.start is None else sl.start for sl in voxels])
        opposite = cs.coordinate(
            [n if sl.stop is None else sl.stop for sl, n in zip(voxels, sizes)]
        )
        extent = np.abs(np.asarray(opposite) - np.asarray(origin))
        metadata = self.metadata()
        # The Cartesian extents in the order of the matrix axes.
        metadata["dimensions"] = [
            float(extent[interpret_indexing(index, "xyz"[: self.space_dim])[0]])
            for index in self.indexing
        ]
        metadata["origin"] = np.asarray(origin)
        return type(self)(img=self.img[voxels], **metadata)

    def roi(self, roi) -> "Image":
        """The subregion of a :class:`~darsia_tpu_torch.image.roi.ROI`."""
        return roi(self)

    def slice(self, cut: Union[float, int], axis: Union[str, int]) -> "Image":
        """The slice normal to ``axis`` at ``cut`` (a view of the tensor): a
        Cartesian axis ("x", "y", "z") takes ``cut`` as a coordinate, a matrix
        axis (int) as a voxel index.

        A cut outside the image picks the plane the JAX package's indexing
        picks: a negative index counts from the end, and what then still lies
        outside is clamped to the first or last plane."""
        from ..signals.reduction.dimensionreduction import reduce_axis

        if isinstance(axis, str):
            full_coordinate = np.zeros(self.space_dim, dtype=float)
            full_coordinate["xyz"[: self.space_dim].find(axis)] = cut
            # The matrix axis the coordinate system maps this Cartesian axis
            # to (in 3-D: x -> 1, y -> 2, z -> 0).
            axis, _ = interpret_indexing(axis, self.indexing)
            cut = int(self.coordinatesystem.voxel(full_coordinate)[axis])
        planes = self.num_voxels[axis]
        cut = min(max(cut + planes if cut < 0 else cut, 0), planes - 1)
        return reduce_axis(self, axis, mode="slice", slice_idx=cut)

    def eval(self, point, interpolation: str = "nearest") -> np.ndarray:
        """The image's values at physical points (``Coordinate`` types or
        float arrays) or voxels (``Voxel`` types or integer arrays), clipped
        to the image: gathered on the device, returned as numpy."""
        pts = np.atleast_2d(np.asarray(point))
        if isinstance(point, (Coordinate, CoordinateArray)) or (
            not isinstance(point, (Voxel, VoxelArray))
            and np.issubdtype(pts.dtype, np.floating)
        ):
            voxels = np.atleast_2d(np.asarray(self.coordinatesystem.voxel(pts)))
        else:
            voxels = pts.astype(int)
        voxels = np.clip(voxels, 0, np.array(self.num_voxels) - 1)
        index = tuple(
            torch.from_numpy(np.ascontiguousarray(voxels[:, d])).to(self.device)
            for d in range(self.space_dim)
        )
        values = as_numpy(self.img[index])
        return values[0] if np.asarray(point).ndim == 1 else values

    def resize(self, cx: float, cy: Optional[float] = None) -> None:
        """Rescale the image in place by the factors (cx, cy) along x and y."""
        from ..restoration.resize import resize as _resize

        cy = cx if cy is None else cy
        ny = max(int(round(self.num_voxels[0] * cy)), 1)
        nx = max(int(round(self.num_voxels[1] * cx)), 1)
        self.img = _resize(self, shape=(ny, nx)).img

    def reset_origin(self, return_image: bool = False):
        """Set the origin to the default (reversed axes span [0, dimension]);
        with ``return_image`` also return an image that keeps the old one."""
        metadata = self.metadata()
        self.origin = np.asarray(
            _default_origin(self.space_dim, self.indexing, self.dimensions), dtype=float
        )
        if return_image:
            return type(self)(img=self.img, **metadata)
        return None

    def geometry(self):
        """The flat :class:`~darsia_tpu_torch.measure.integration.Geometry`
        of this image."""
        from ..measure.integration import Geometry

        return Geometry(**self.shape_metadata())

    def integral(self) -> float:
        """Integral over space of a scalar single image."""
        if not self.scalar:
            raise NotImplementedError("Integration only implemented for scalar images.")
        if self.series:
            raise NotImplementedError("Integration only implemented for single images.")
        return float(self.geometry().integrate(self))

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

    def to_vtk(self, path, name: str = "data") -> None:
        raise _absent("to_vtk", "a VTK writer")

    def show(self, *args, **kwargs) -> None:
        raise _absent("show", "matplotlib")

    show_matplotlib = show_plain = show

    def show_plotly(self, *args, **kwargs) -> None:
        raise _absent("show_plotly", "plotly")

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

    def write(self, path: Union[str, Path], **kwargs) -> None:
        """Write the data to ``.npy`` or ``.csv`` (rows of axis 0)."""
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
            raise _absent(f"writing {suffix} files", "an image encoder (cv2)")
        data = self.as_numpy()
        path.parent.mkdir(parents=True, exist_ok=True)
        if suffix == ".npy":
            np.save(path, data)
        elif suffix == ".csv":
            np.savetxt(path, data.reshape(data.shape[0], -1), delimiter=",")
        else:
            raise NotImplementedError(f"Suffix {suffix} not supported.")

    def to_csv(
        self,
        path: Union[str, Path],
        *,
        delimiter: str = ",",
        header: Optional[str] = None,
        float_format: str = "{:.2e}",
    ) -> None:
        """Write one row per voxel: the cell centre's coordinates, then the
        value (``x[, y[, z]], value``)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arr = self.as_numpy()
        if arr.ndim != self.space_dim:
            raise ValueError(
                "to_csv requires a non-series scalar image (array rank == space_dim)."
            )
        use_header = None if header is None else str(header).strip()
        if use_header is not None and use_header.lower() == "none":
            use_header = None
        if use_header is not None:
            columns = [part.strip() for part in use_header.split(delimiter)]
            if len(columns) != self.space_dim + 1:
                raise ValueError(f"CSV header must provide {self.space_dim + 1} columns.")
        centers = (
            np.stack(
                np.meshgrid(*(np.arange(n) for n in arr.shape), indexing="ij"), axis=-1
            ).reshape(-1, self.space_dim)
            + 0.5
        )
        coords = np.asarray(self.coordinatesystem.coordinate(centers), dtype=float)
        fmt = float_format.strip()
        if fmt.startswith("{:") and fmt.endswith("}"):
            fmt = "%" + fmt[2:-1]
        table = np.concatenate([coords, arr.reshape(-1, 1).astype(float)], axis=1)
        np.savetxt(
            path, table, delimiter=delimiter, fmt=fmt, header=use_header or "", comments=""
        )


class ExtensiveImage(ScalarImage):
    """Image of an extensive (integrable) quantity: its integral is the sum
    of its values."""


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

    def add_grid(
        self,
        origin=None,
        dx: float = 1.0,
        dy: float = 1.0,
        color: tuple = (125, 125, 125),
        thickness: int = 9,
    ) -> "OpticalImage":
        """A copy with a Cartesian grid drawn over it (on the host; for
        visual checks)."""
        origin = np.asarray(self.origin if origin is None else origin, dtype=float)
        data = np.array(self.as_numpy(), copy=True)
        if np.issubdtype(data.dtype, np.floating):
            color = tuple(c / 255.0 for c in color)
        cs = self.coordinatesystem
        num_h = int(np.ceil(self.dimensions[1] / dx)) + 1
        num_v = int(np.ceil(self.dimensions[0] / dy)) + 1
        h, w = self.num_voxels
        half = thickness // 2
        for n in range(-num_h, num_h + 1):
            col = int(cs.voxel(np.array([origin[0] + n * dx, origin[1]]))[1])
            if 0 <= col < w:
                data[:, max(col - half, 0) : col + half + 1, :3] = color[:3]
        for n in range(-num_v, num_v + 1):
            row = int(cs.voxel(np.array([origin[0], origin[1] + n * dy]))[0])
            if 0 <= row < h:
                data[max(row - half, 0) : row + half + 1, :, :3] = color[:3]
        return OpticalImage(img=data, device=self.device, **self.metadata())

    def write(self, path, **kwargs) -> None:
        raise _absent("writing photographs", "an image encoder (cv2)")

    def encode(self, suffix: str, **kwargs) -> bytes:
        raise _absent("encoding photographs", "an image encoder (cv2)")
