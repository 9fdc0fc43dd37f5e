"""Binary mask cleanup (small objects, holes, local convex cover).

Counterpart of :mod:`darsia_tpu.restoration.binaryinpaint`: host-side numpy
on :mod:`darsia_tpu_torch.utils.morphology`, as there.  A tensor mask is
copied to the host; the result is a numpy array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..image.image import as_numpy

from ..utils.morphology import (
    convex_hull_image,
    remove_small_holes,
    remove_small_objects,
)

__all__ = ["BinaryRemoveSmallObjects", "BinaryFillHoles", "BinaryLocalConvexCover"]


class BinaryRemoveSmallObjects:
    """Remove connected components below a minimum size."""

    def __init__(self, min_size: Optional[int] = None, key: str = "", **kwargs):
        self.min_size = (
            kwargs.get(key + "remove small objects size", 1)
            if min_size is None
            else min_size
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.min_size > 1:
            return remove_small_objects(as_numpy(img), min_size=self.min_size)
        return as_numpy(img)


class BinaryFillHoles:
    """Fill holes below an area threshold."""

    def __init__(self, area_threshold: Optional[int] = None, key: str = "", **kwargs):
        self.area_threshold = (
            kwargs.get(key + "fill holes size", 0)
            if area_threshold is None
            else area_threshold
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.area_threshold > 0:
            return remove_small_holes(
                as_numpy(img), area_threshold=self.area_threshold
            )
        return as_numpy(img)


class BinaryLocalConvexCover:
    """Cover the mask by convex hulls computed on local patches."""

    def __init__(self, cover_patch_size: Optional[int] = None, key: str = "", **kwargs):
        self.cover_patch_size = (
            kwargs.get(key + "local convex cover size", 0)
            if cover_patch_size is None
            else cover_patch_size
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = as_numpy(img).astype(bool)
        size = self.cover_patch_size
        if size <= 1:
            return img
        covered = np.zeros(img.shape[:2], dtype=bool)
        Ny, Nx = img.shape[:2]
        for row in range(Ny // size):
            for col in range(Nx // size):
                roi = (
                    slice(row * size, (row + 1) * size),
                    slice(col * size, (col + 1) * size),
                )
                covered[roi] = convex_hull_image(img[roi])
        return covered
