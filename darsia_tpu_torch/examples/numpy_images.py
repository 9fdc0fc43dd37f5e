"""Images from raw numpy arrays.

The port of the JAX package's ``examples/numpy_images.py``: a scalar image
and an RGB image from arrays, and a two-step series.
"""

from __future__ import annotations

import numpy as np

from .. import imread_from_numpy, stack, weight
from ..image.image import card_unless
from . import Report, cli


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the numpy images example")
    report = Report()
    # Scalar image from a plain array with physical dimensions.
    array = np.linspace(0, 1, 50 * 80).reshape(50, 80).astype(np.float32)
    image = imread_from_numpy(array, width=0.8, height=0.5, scalar=True, device=device)
    report("scalar image:", tuple(image.shape), image.dimensions)

    # Optical (RGB) image.
    rgb = np.stack([array, array**2, np.sqrt(array)], axis=-1)
    optical = imread_from_numpy(rgb, width=0.8, height=0.5, device=device)
    report("optical image:", type(optical).__name__)

    # Series: stack several time steps.
    series = stack([image, weight(image, 0.5)])
    report("series time steps:", series.time_num)
    return {"lines": report.lines}


if __name__ == "__main__":
    cli(main)
