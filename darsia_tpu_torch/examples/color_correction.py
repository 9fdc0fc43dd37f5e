"""Colour corrections: colour checker detection and correction, balances.

The port of the JAX package's ``examples/color_correction.py``: a 4x6
checker painted into the baseline is found, ``ColorCorrection`` warps its
crop (one K1 pair on the card) and corrects the frame, and
``AdaptiveBalance`` maps the observed swatches onto the reference ones.
"""

from __future__ import annotations

import numpy as np

from .. import AdaptiveBalance, ColorCheckerAfter2014, ColorCorrection, Image, find_colorchecker
from ..image.image import as_numpy, card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the colour correction example")
    report = Report()
    image = load_baseline(device=device)

    # The checker correction needs a checker in the frame; paint one.
    arr = as_numpy(image.img).copy()
    ref = ColorCheckerAfter2014().swatches_rgb
    r0, c0, cell = 10, 10, 12
    for i in range(4):
        for j in range(6):
            arr[r0 + i * cell : r0 + (i + 1) * cell, c0 + j * cell : c0 + (j + 1) * cell] = 0.9 * ref[i, j]
    with_checker = Image(arr, device=device, **image.metadata())

    checker, voxels = find_colorchecker(with_checker, "upper_left")
    correction = ColorCorrection(with_checker, config={"roi": voxels})
    correction(with_checker)
    error = float(np.abs(np.asarray(checker.swatches_rgb) - ref).mean())
    report("corrected swatch error:", error)

    # Closed-form balances: map observed swatches onto the reference swatches.
    balance = AdaptiveBalance()
    balanced = balance(
        with_checker.img, np.asarray(checker.swatches_rgb).reshape(-1, 3), ref.reshape(-1, 3)
    )
    report("adaptive balance output shape:", tuple(balanced.shape))
    return {"lines": report.lines, "swatch_error": error}


if __name__ == "__main__":
    cli(main)
