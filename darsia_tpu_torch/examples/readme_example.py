"""First steps with physical-coordinate images.

The port of the JAX package's ``examples/readme_example.py``: a grid drawn
over the baseline, a region of interest cut by two coordinates, the
metadata, and the data itself, a tensor on the image's device.  ``show()``
runs only where an interactive matplotlib backend can open a window; where
matplotlib does not import, that check raises naming it, the view is
skipped and the message is returned under ``"missing"``.
"""

from __future__ import annotations

import numpy as np

from .. import make_coordinate
from ..assistants.base_assistant import interactive_available
from ..image.image import card_unless
from . import Report, cli, missing_library
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the README example")
    report = Report()
    image = load_baseline(device=device)

    # Take a look (opens a window when a display is available).
    missing = []
    try:
        if interactive_available():
            image.show()
    except ImportError as err:
        missing.append(missing_library(err, "matplotlib"))

    # Copy the image and add a grid on top of it.
    grid_image = image.add_grid(dx=0.1, dy=0.1)
    report("grid image:", tuple(grid_image.shape))

    # Extract a region of interest (box defined by two coordinates).
    roi = make_coordinate(np.array([[1.5, 0.0], [2.8, 0.7]]))
    roi_image = image.subregion(roi)
    report("ROI voxels:", tuple(roi_image.shape))

    # Metadata travels with the image.
    report("metadata keys:", sorted(image.metadata().keys()))

    # The underlying array is a tensor on the image's device.
    array = image.img
    report("array type:", type(array).__name__, "dtype:", array.dtype, "device:", array.device)
    return {"lines": report.lines, "missing": missing}


if __name__ == "__main__":
    cli(main)
