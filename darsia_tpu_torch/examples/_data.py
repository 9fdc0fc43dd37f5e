"""The examples' synthetic rig data, built on the device asked for.

The counterpart of the JAX package's ``examples/_data.py:47-71``: the same
seeded baseline (uniform in [0.35, 0.6], seed 0) and the same three CO2
frames (a reddened block that grows 30, 60, 90 rows), made with numpy on the
host and then placed on ``device`` (the card when None).  Both are built as
``OpticalImage``, as the JAX package's real-photograph branch reads them:
its synthetic branch builds a plain ``Image``, which has no colour
conversions, so four of its examples stop there (reference fault 1).  The
real-photograph branch is not ported: the lab photographs are not in the
repository.
"""

from __future__ import annotations

import numpy as np

from ..image.image import OpticalImage, card_unless

__all__ = ["baseline_array", "load_baseline", "load_co2_series"]

META = {"width": 2.8, "height": 1.5, "color_space": "RGB"}


def baseline_array(shape=(270, 512)) -> np.ndarray:
    """The baseline's float32 (H, W, 3) data on the host."""
    rng = np.random.default_rng(0)
    return rng.uniform(0.35, 0.6, size=tuple(shape) + (3,)).astype(np.float32)


def load_baseline(shape=(270, 512), device=None) -> OpticalImage:
    """The seeded baseline photograph on ``device`` (the card when None)."""
    return OpticalImage(baseline_array(shape), device=card_unless(device), **META)


def load_co2_series(shape=(270, 512), device=None) -> list:
    """Three frames one hour apart, a reddened block growing in each."""
    device = card_unless(device)
    base = baseline_array(shape)
    out = []
    for i, growth in enumerate((30, 60, 90)):
        arr = base.copy()
        arr[40 : 40 + growth, 60 : 60 + 2 * growth] += [0.25, -0.08, -0.08]
        img = OpticalImage(np.clip(arr, 0, 1), device=device, **META)
        img.time = 3600.0 * (i + 1)
        out.append(img)
    return out
