"""Physical-coordinate images: coordinates, voxels, subregions.

The port of the JAX package's ``examples/reading_images.py``: images carry
physical dimensions; matrix indexing has its origin top left, Cartesian
coordinates bottom left.
"""

from __future__ import annotations

import numpy as np

from .. import make_coordinate
from ..image.image import card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the reading images example")
    report = Report()
    image = load_baseline(device=device)
    report("shape:", tuple(image.shape))
    report("dimensions [m]:", image.dimensions)
    report("origin:", image.origin)

    # Coordinate <-> voxel mapping.
    center_voxel = [image.num_voxels[0] // 2, image.num_voxels[1] // 2]
    center_coordinate = image.coordinatesystem.coordinate(center_voxel)
    report("center voxel:", center_voxel, "-> coordinate:", center_coordinate)
    report("back to voxel:", image.coordinatesystem.voxel(center_coordinate))

    # Subregions in physical coordinates.
    sub = image.subregion(make_coordinate(np.array([[0.5, 0.25], [1.5, 1.0]])))
    report("subregion voxels:", tuple(sub.shape))

    # Monochromatic views, reduced on the device.
    gray = image.to_monochromatic("gray")
    gray_range = (float(gray.img.min()), float(gray.img.max()))
    report("gray range:", *gray_range)
    return {"lines": report.lines, "gray_range": gray_range}


if __name__ == "__main__":
    cli(main)
