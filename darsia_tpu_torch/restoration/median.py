"""Median filtering over a disk footprint.

Counterpart of :mod:`darsia_tpu.restoration.median`: the footprint's shifts
of the image are stacked and the median taken across them, on the image's
device.  The shifts wrap around (``roll``), so the filter is periodic at the
border, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.image import as_tensor
from ..utils.morphology import disk

__all__ = ["Median", "median_filter"]


def median_filter(img, disk_radius: int = 1, device=None) -> torch.Tensor:
    """Median filter over a disk footprint (first two axes)."""
    img = as_tensor(img, device)
    footprint = disk(disk_radius)
    offsets = [
        (int(dy) - disk_radius, int(dx) - disk_radius) for dy, dx in np.argwhere(footprint)
    ]
    # torch.median takes the lower middle value and the JAX package's median
    # the mean of the middle pair: they agree for an odd count only.
    if len(offsets) % 2 != 1:
        raise ValueError("the footprint must hold an odd number of voxels")
    stacked = torch.stack(
        [torch.roll(img, shifts=offset, dims=(0, 1)) for offset in offsets]
    )
    return torch.median(stacked, dim=0).values


class Median:
    """Median filter restoration object (``"disk radius"`` in ``kwargs``,
    optionally prefixed by ``key``)."""

    def __init__(self, key: str = "", **kwargs) -> None:
        self.disk_radius: int = kwargs.get(key + "disk radius", 1)
        self.device = kwargs.get("device")

    def __call__(self, img):
        if hasattr(img, "img"):
            out = img.copy()
            out.img = median_filter(img.img, self.disk_radius)
            return out
        return median_filter(img, self.disk_radius, self.device)
