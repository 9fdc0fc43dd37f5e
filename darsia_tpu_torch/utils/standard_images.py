"""Standardized image constructors (ROI masks).

Counterpart of :mod:`darsia_tpu.utils.standard_images` (``roi_to_mask``;
``zeros_like`` and ``ones_like`` are in :mod:`darsia_tpu_torch.image.arithmetics`).
The mask is rasterized on the host, then copied once to the reference
image's device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from ..image.image import Image

__all__ = ["StandardDtype", "roi_to_mask"]


def _corner_voxels(roi, reference_image) -> tuple:
    """Bounding-box corner voxels (rows, columns) of one ROI."""
    arr = np.asarray(roi.roi if hasattr(roi, "roi") else roi, dtype=float)
    if arr.shape != (2, 2):
        raise ValueError("ROI must be a (2, 2) array of two corners.")
    # Integer-valued entries larger than the height are voxels; else coordinates.
    if np.allclose(arr, np.round(arr)) and arr.max() > reference_image.dimensions[0]:
        voxels = np.round(arr).astype(int)
    else:
        voxels = np.asarray(reference_image.coordinatesystem.voxel(arr))
    lo = np.minimum(voxels[0], voxels[1])
    hi = np.maximum(voxels[0], voxels[1])
    return lo, hi


def roi_to_mask(roi, reference_image, mode: str = "voxels") -> Image:
    """Boolean mask image covering one box ROI or the union of several, on
    the reference image's device."""
    rois = roi if isinstance(roi, list) else [roi]
    shape = tuple(reference_image.num_voxels[:2])
    arr = np.zeros(tuple(reference_image.num_voxels[: reference_image.space_dim]), dtype=bool)
    for entry in rois:
        lo, hi = _corner_voxels(entry, reference_image)
        r0, r1 = np.clip([lo[0], hi[0]], 0, shape[0])
        c0, c1 = np.clip([lo[1], hi[1]], 0, shape[1])
        arr[r0:r1, c0:c1] = True
    meta = reference_image.metadata()
    meta["scalar"] = True
    meta["series"] = False
    return Image(arr, device=reference_image.img.device, **meta)


StandardDtype = Literal[np.uint8, np.uint16, np.float32, np.float64, np.bool_]
