"""Binary morphology on the host (numpy and scipy).

Counterpart of :mod:`darsia_tpu.utils.morphology`, which is numpy code
there too: connected-component labelling, dilation and erosion run through
``scipy.ndimage`` (set-up and mask clean-up paths, not per-frame work),
convex hulls through ``scipy.spatial``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage
from scipy.spatial import Delaunay, QhullError

__all__ = [
    "disk",
    "binary_dilation",
    "binary_erosion",
    "remove_small_objects",
    "remove_small_holes",
    "convex_hull_image",
    "label",
    "binary_fill_holes",
    "skeletonize",
    "find_boundaries",
]


def disk(radius: int) -> np.ndarray:
    """Circular footprint of given radius."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return (X**2 + Y**2) <= radius**2


def binary_dilation(img: np.ndarray, footprint: Optional[np.ndarray] = None) -> np.ndarray:
    return ndimage.binary_dilation(img, structure=footprint)


def binary_erosion(img: np.ndarray, footprint: Optional[np.ndarray] = None) -> np.ndarray:
    return ndimage.binary_erosion(img, structure=footprint)


def label(img: np.ndarray, connectivity: int = 1):
    """Connected-component labelling; returns (labels, num)."""
    structure = ndimage.generate_binary_structure(img.ndim, connectivity)
    return ndimage.label(img, structure=structure)


def remove_small_objects(img: np.ndarray, min_size: int = 1) -> np.ndarray:
    """Drop connected components smaller than ``min_size`` pixels."""
    img = np.asarray(img, dtype=bool)
    if min_size <= 1:
        return img
    labels, num = label(img, connectivity=2)
    if num == 0:
        return img
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[labels]


def remove_small_holes(img: np.ndarray, area_threshold: int = 0) -> np.ndarray:
    """Fill background holes smaller than ``area_threshold`` pixels."""
    img = np.asarray(img, dtype=bool)
    if area_threshold <= 0:
        return img
    complement = ~img
    labels, num = label(complement, connectivity=1)
    if num == 0:
        return img
    sizes = np.bincount(labels.ravel())
    # A "hole" is a background component not touching the border.
    border_labels = np.unique(
        np.concatenate(
            [labels[0, :], labels[-1, :], labels[:, 0], labels[:, -1]]
        )
    )
    fill = sizes < area_threshold
    fill[0] = False
    fill[border_labels] = False
    return img | fill[labels]


def binary_fill_holes(img: np.ndarray) -> np.ndarray:
    return ndimage.binary_fill_holes(img)


def convex_hull_image(img: np.ndarray) -> np.ndarray:
    """Binary mask of the convex hull of the True pixels."""
    img = np.asarray(img, dtype=bool)
    pts = np.argwhere(img)
    if pts.shape[0] < 3:
        return img.copy()
    try:
        hull = Delaunay(pts)
    except QhullError:  # degenerate (collinear) point sets
        return img.copy()
    grid = np.indices(img.shape).reshape(img.ndim, -1).T
    inside = hull.find_simplex(grid) >= 0
    return inside.reshape(img.shape)


def skeletonize(img: np.ndarray) -> np.ndarray:
    """Morphological skeleton (Lantuejoul's formula with a cross structuring
    element): not the Zhang-Suen thinning skeleton, but topologically
    equivalent for centreline extraction."""
    img = np.asarray(img, dtype=bool)
    structure = ndimage.generate_binary_structure(2, 1)
    skel = np.zeros_like(img)
    eroded = img.copy()
    while eroded.any():
        opened = ndimage.binary_opening(eroded, structure=structure)
        skel |= eroded & ~opened
        eroded = ndimage.binary_erosion(eroded, structure=structure)
    return skel


def find_boundaries(labels: np.ndarray, mode: str = "outer", connectivity: int = 1) -> np.ndarray:
    """Boolean mask of pixels adjacent to a different label (``mode`` and
    ``connectivity`` are accepted for the signature; faces only)."""
    labels = np.asarray(labels)
    boundary = np.zeros(labels.shape, dtype=bool)
    for axis in range(labels.ndim):
        diff = np.diff(labels, axis=axis) != 0
        lo = [slice(None)] * labels.ndim
        hi = [slice(None)] * labels.ndim
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        boundary[tuple(lo)] |= diff
        boundary[tuple(hi)] |= diff
    return boundary
