"""Concentration analysis by kernel interpolation of calibration colours.

The port of the JAX package's ``examples/kernel_interpolation.py``: a
``MultichromaticTracerAnalysis`` with a Gaussian kernel is calibrated on one
sample box of a reddened band and evaluated on the whole frame.
"""

from __future__ import annotations

import numpy as np

from .. import GaussianKernel, Image, MultichromaticTracerAnalysis
from ..image.image import as_numpy, card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the kernel interpolation example")
    report = Report()
    baseline = load_baseline(shape=(135, 256), device=device)

    # Tracer image: a reddened band.
    arr = as_numpy(baseline.img).copy()
    arr[50:90, 60:200] = np.clip(arr[50:90, 60:200] + [0.25, -0.05, -0.05], 0, 1)
    tracer = Image(arr, device=device, **baseline.metadata())

    analysis = MultichromaticTracerAnalysis(baseline, relative=True, kernel=GaussianKernel(gamma=9.73))
    analysis.calibrate_from_samples(
        tracer,
        samples_per_label=[[(slice(55, 85), slice(80, 120))]],
        concentrations_per_label=[[1.0]],
        num_clusters=3,
    )
    concentration = analysis(tracer)
    plume, outside = float(concentration.img[70, 100]), float(concentration.img[20, 20])
    report("concentration in plume:", plume)
    report("concentration outside:", outside)
    return {"lines": report.lines, "plume": plume, "outside": outside}


if __name__ == "__main__":
    cli(main)
