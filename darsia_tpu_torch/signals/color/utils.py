"""Colour utilities.

Counterpart of :mod:`darsia_tpu.signals.color.utils`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor

__all__ = ["get_mean_color"]


def get_mean_color(image, mask=None, robust: bool = True) -> np.ndarray:
    """Median (``robust``) or mean colour over a masked region, reduced on the
    image's device (a numpy image goes to the card); the colour comes back as
    a host array."""
    data = as_tensor(image.img if hasattr(image, "img") else image)
    flat = data.reshape(-1, data.shape[-1])
    if mask is not None:
        mask = mask.img if hasattr(mask, "img") else mask
        flat = flat[as_tensor(mask, data.device).to(torch.bool).reshape(-1)]
    if robust:
        # numpy's median: the mean of the two middle values of an even count.
        ordered = flat.sort(dim=0).values
        n = ordered.shape[0]
        return as_numpy((ordered[(n - 1) // 2] + ordered[n // 2]) / 2)
    return as_numpy(flat.mean(dim=0))
