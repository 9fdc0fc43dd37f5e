"""Reading images from files: photographs, numpy arrays and saved images.

Counterpart of :mod:`darsia_tpu.image.imread` for ``.jpg``/``.jpeg``/
``.png``/``.tif``/``.tiff`` photographs (decoded by OpenCV, imported when
called), ``.npy`` and ``.npz`` files, folders and lists of them, and encoded
bytes.  The array is decoded on the host and goes to ``device`` (the CUDA
card unless the caller asks for another), where the transformation chain
runs; ``transfer="yuv420"`` ships a photograph at 1.5 bytes per pixel
(:mod:`darsia_tpu_torch.utils.transfer`).  DICOM slice stacks (pydicom) and
VTU meshes (meshio, resampled on the host by scipy's ``griddata``) are read
through their libraries, imported when called.

An npz written by the JAX package's ``Image.save`` pickles its metadata, with
the origin as a point type of that package; it is read through
:func:`darsia_tpu_torch.utils.npz.load_npz`, which resolves such types to
this package's, so no file needs the JAX package.
"""

from __future__ import annotations

import logging
import time as _time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.npz import load_npz
from ..utils.optional import optional_module
from .image import ExtensiveImage, Image, OpticalImage, ScalarImage, as_tensor

logger = logging.getLogger(__name__)

__all__ = [
    "imread",
    "imread_from_bytes",
    "imread_from_dicom",
    "imread_from_numpy",
    "imread_from_npz",
    "imread_from_optical",
    "imread_from_vtu",
]

_CLASSES = {
    "Image": Image,
    "ScalarImage": ScalarImage,
    "ExtensiveImage": ExtensiveImage,
    "OpticalImage": OpticalImage,
}

_OPTICAL = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def imread(path, **kwargs) -> Image:
    """Read image(s) from file; format dispatch by suffix.

    Args:
        path: path(s) to file(s) or folder(s).
        kwargs: format-specific options, forwarded; ``device`` says where
            the data goes (default: the CUDA card).

    Returns:
        Image (series if multiple paths given).

    """
    tic = _time.time()
    if isinstance(path, list):
        path = [Path(p) for p in path]
    else:
        path = Path(path)

    # Expand folders.
    if isinstance(path, Path) and path.is_dir():
        path = sorted(p for p in path.glob("*") if p.is_file())
    elif isinstance(path, list) and all(p.is_dir() for p in path):
        expanded: list[Path] = []
        for p in path:
            expanded.extend(q for q in p.glob("*") if q.is_file())
        path = sorted(expanded)

    for p in path if isinstance(path, list) else [path]:
        if not p.exists():
            raise FileNotFoundError(f"File {p} does not exist.")

    suffix = kwargs.get("suffix", None)
    if suffix is None:
        suffix = (path[0] if isinstance(path, list) else path).suffix
        suffix = str(suffix).lower()

    if suffix == ".npy":
        image = imread_from_numpy(path, **kwargs)
    elif suffix == ".npz":
        image = imread_from_npz(path, **kwargs)
    elif suffix in _OPTICAL:
        image = imread_from_optical(path, **kwargs)
    elif suffix == ".dcm":
        image = imread_from_dicom(path, **kwargs)
    elif suffix == ".vtu":
        image = imread_from_vtu(path, **kwargs)
    else:
        raise NotImplementedError(f"Filetype {suffix} not supported.")

    logger.info("Image reading for %s took %.2f s.", path, _time.time() - tic)
    return image


def imread_from_bytes(data: bytes, transformations=None, **kwargs) -> Image:
    """Decode an in-memory encoded image (png/jpg bytes): an OpticalImage of
    a colour image, a ScalarImage of a one-channel one."""
    cv2 = optional_module("cv2", "decoding image bytes")
    array = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if array is None:
        raise ValueError("Could not decode image bytes.")
    if array.ndim == 3 and array.shape[-1] == 3:
        array = cv2.cvtColor(array, cv2.COLOR_BGR2RGB)
        return OpticalImage(img=array, transformations=transformations, **kwargs)
    if array.ndim == 2:
        return ScalarImage(img=array, transformations=transformations, **kwargs)
    if array.ndim == 3 and array.shape[-1] == 1:
        return ScalarImage(img=array[..., 0], transformations=transformations, **kwargs)
    raise NotImplementedError


def imread_from_numpy(path, **kwargs) -> Image:
    """Read a raw npy array (a path, an in-memory ndarray, or a list of
    either: a series) as an Image."""
    kwargs.pop("suffix", None)
    if isinstance(path, np.ndarray):
        return Image(path, **kwargs)
    if isinstance(path, list):
        arrays = [p if isinstance(p, np.ndarray) else np.load(p) for p in path]
        array = np.stack(arrays, axis=kwargs.get("space_dim", 2))
        kwargs.setdefault("series", True)
        return Image(array, **kwargs)
    return Image(np.load(path), **kwargs)


def imread_from_npz(path, transformations=None, **kwargs) -> Image:
    """Read an Image that ``Image.save`` of either package wrote."""
    kwargs.pop("suffix", None)
    npzdata = load_npz(path)
    metadata = npzdata["metadata"]
    metadata = metadata[0] if metadata.ndim else metadata.item()
    metadata = dict(metadata)
    cls_name = str(npzdata["image_class"]) if "image_class" in npzdata else None
    cls_name = metadata.pop("type", cls_name) or "Image"
    metadata.update(kwargs)
    klass = _CLASSES.get(cls_name, Image)
    return klass(npzdata["array"], transformations=transformations, **metadata)


def _exif_date(path: Path) -> Optional[datetime]:
    """Acquisition datetime from a photograph's EXIF, if present.

    Best effort, as in the JAX package: None on any failure, including where
    PIL is not installed (the card's machine), and for files without EXIF
    such as ``.npz``; the protocol set-up then falls back to the file's
    modification time.
    """
    try:
        from PIL import Image as PILImage
        from PIL.ExifTags import TAGS

        with PILImage.open(path) as im:
            exif = im.getexif()
            if not exif:
                return None
            for tag_id, value in exif.items():
                if TAGS.get(tag_id) in ("DateTimeOriginal", "DateTime"):
                    return datetime.strptime(str(value), "%Y:%m:%d %H:%M:%S")
    except Exception:  # noqa: BLE001 - EXIF is best-effort
        return None
    return None


def _read_single_optical(path: Path) -> np.ndarray:
    """One photograph decoded on the host: RGB for a colour file, the file's
    own channels and depth otherwise."""
    cv2 = optional_module("cv2", "reading photographs")
    array = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if array is None:
        raise ValueError(f"Could not read image {path}.")
    if array.ndim == 3 and array.shape[-1] == 3:
        array = cv2.cvtColor(array, cv2.COLOR_BGR2RGB)
    return array


def imread_from_optical(
    path,
    time=None,
    transformations=None,
    transfer: Optional[str] = None,
    **kwargs,
) -> OpticalImage:
    """Read jpg/png/tif photograph(s) into an OpticalImage on ``device``.

    A list of paths gives a series on the time axis (after the two space
    axes).  ``transfer="yuv420"`` ships each decoded uint8 RGB frame to the
    device as a full-resolution luma plane and two 2x2-subsampled chroma
    planes (1.5 bytes per pixel instead of 3) and rebuilds RGB there
    (:func:`darsia_tpu_torch.utils.transfer.put_rgb_yuv420`).  The dates
    come from ``date`` or from each file's EXIF (None without PIL).
    """
    import torch

    kwargs.pop("suffix", None)
    device = kwargs.pop("device", None)

    def promote(arr: np.ndarray):
        if transfer == "yuv420" and arr.ndim == 3 and arr.shape[-1] == 3 and arr.dtype == np.uint8:
            from ..utils.transfer import put_rgb_yuv420

            return put_rgb_yuv420(arr, device=device)
        return arr

    if isinstance(path, list):
        arrays = [promote(_read_single_optical(p)) for p in path]
        dates = kwargs.pop("date", None)
        if dates is None:
            dates = [_exif_date(p) for p in path]
        if any(isinstance(a, torch.Tensor) for a in arrays):
            array = torch.stack([as_tensor(a, device) for a in arrays], dim=2)
        else:
            array = np.stack(arrays, axis=2)
        return OpticalImage(
            img=array,
            series=True,
            date=dates,
            time=time,
            transformations=transformations,
            device=device,
            **kwargs,
        )

    array = promote(_read_single_optical(path))
    date = kwargs.pop("date", None)
    if date is None:
        date = _exif_date(path)
    return OpticalImage(
        img=array, date=date, time=time, transformations=transformations, device=device, **kwargs
    )


# --------------------------------------------------------------------- DICOM


def imread_from_dicom(path, **kwargs) -> ScalarImage:
    """Read DICOM slices (a file or a list) into a 3-D ScalarImage: ordered
    by SliceLocation (else InstanceNumber), the modality LUT applied, the
    dimensions from SliceThickness and PixelSpacing.  Needs pydicom."""
    what = "reading DICOM (.dcm) files"
    pydicom = optional_module("pydicom", what)
    util = optional_module("pydicom.pixel_data_handlers.util", what)

    slices = []
    for p in path if isinstance(path, list) else [path]:
        ds = pydicom.dcmread(str(p))
        slices.append((ds, util.apply_modality_lut(ds.pixel_array, ds)))

    def sort_key(item):
        ds = item[0]
        return float(getattr(ds, "SliceLocation", getattr(ds, "InstanceNumber", 0)))

    slices.sort(key=sort_key)
    volume = np.stack([d for _, d in slices], axis=0)
    ds0 = slices[0][0]
    spacing = [float(s) for s in getattr(ds0, "PixelSpacing", [1.0, 1.0])]
    thickness = float(getattr(ds0, "SliceThickness", 1.0))
    dimensions = [
        thickness * volume.shape[0],
        spacing[0] * volume.shape[1],
        spacing[1] * volume.shape[2],
    ]
    kwargs.setdefault("dimensions", dimensions)
    kwargs.setdefault("space_dim", 3)
    return ScalarImage(volume, **kwargs)


# ----------------------------------------------------------------------- VTU


def imread_from_vtu(path, key: str = "data", **kwargs) -> Image:
    """Read the field ``key`` of VTU meshes (a file, or a list: a series),
    resampled on the host onto a regular grid of ``shape`` (default
    200 x 200) spanning the mesh's bounding box.  Needs meshio."""
    meshio = optional_module("meshio", "reading VTU (.vtu) files")

    paths = path if isinstance(path, list) else [path]
    arrays = [_resample_vtu(meshio.read(str(p)), key, **kwargs) for p in paths]
    kwargs.setdefault("dimensions", arrays[0][1])
    kwargs.pop("shape", None)
    if len(arrays) == 1:
        return ScalarImage(arrays[0][0], **kwargs)
    data = np.stack([a for a, _ in arrays], axis=2)
    return ScalarImage(data, series=True, **kwargs)


def _resample_vtu(mesh, key: str, **kwargs):
    """(grid, dimensions): the point data ``key``, else the first cell
    block's, linearly interpolated at the grid's voxel rows (top to bottom)
    and columns; 0 outside the data's hull."""
    from scipy.interpolate import griddata

    points = mesh.points[:, :2]
    values = None
    if key in mesh.point_data:
        values = np.asarray(mesh.point_data[key]).squeeze()
        sample_pts = points
    else:
        for block, data in zip(mesh.cells, mesh.cell_data.get(key, [])):
            centers = mesh.points[block.data].mean(axis=1)[:, :2]
            values = np.asarray(data).squeeze()
            sample_pts = centers
            break
    if values is None:
        raise KeyError(f"Key {key} not found in vtu data.")

    shape = kwargs.get("shape", (200, 200))
    xmin, ymin = points.min(axis=0)
    xmax, ymax = points.max(axis=0)
    gy, gx = np.meshgrid(
        np.linspace(ymax, ymin, shape[0]),
        np.linspace(xmin, xmax, shape[1]),
        indexing="ij",
    )
    grid = griddata(sample_pts, values, (gx, gy), method="linear", fill_value=0.0)
    return grid, [ymax - ymin, xmax - xmin]
