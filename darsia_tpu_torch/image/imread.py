"""Reading images from files: numpy arrays and saved images.

Counterpart of :mod:`darsia_tpu.image.imread` for ``.npy`` and ``.npz``
files, folders and lists of them.  The array is decoded on the host and goes
to ``device`` (the CUDA card unless the caller asks for another), where the
transformation chain runs.  The other formats of the JAX package need
decoders that are not part of this package's environment (OpenCV, pydicom,
meshio) and raise ``NotImplementedError`` naming the decoder.

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
from .image import ExtensiveImage, Image, OpticalImage, ScalarImage

logger = logging.getLogger(__name__)

__all__ = ["imread", "imread_from_numpy", "imread_from_npz"]

_CLASSES = {
    "Image": Image,
    "ScalarImage": ScalarImage,
    "ExtensiveImage": ExtensiveImage,
    "OpticalImage": OpticalImage,
}

#: Suffixes the JAX package reads, and the decoder each needs.
_MISSING_DECODERS = {
    **dict.fromkeys((".jpg", ".jpeg", ".png", ".tif", ".tiff"), "cv2 (OpenCV)"),
    ".dcm": "pydicom",
    ".vtu": "meshio",
}


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
    elif suffix in _MISSING_DECODERS:
        raise NotImplementedError(
            f"reading {suffix} files needs {_MISSING_DECODERS[suffix]}, which is not "
            "ported; decode the file elsewhere and pass the array to Image"
        )
    else:
        raise NotImplementedError(f"Filetype {suffix} not supported.")

    logger.info("Image reading for %s took %.2f s.", path, _time.time() - tic)
    return image


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
