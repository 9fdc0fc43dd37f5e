"""4-D space-time images (DICOM-style CT data).

The port of the JAX package's ``examples/dicom_images.py`` (synthetic
branch; no DICOM files are in the repository): a 4-D space-time image is
sliced in time, restricted to a spatial ROI and reduced along z by
vertical averaging.  ``imread`` of ``.dcm`` files reads such an image where
pydicom imports.
"""

from __future__ import annotations

import numpy as np

from .. import AxisReduction, ScalarImage
from ..image.image import card_unless
from . import Report, cli


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the DICOM images example")
    report = Report()
    # A synthetic 4-D space-time volume: a blob drifting through time.
    T, Z, Y, X = 12, 16, 24, 24
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, Z), np.linspace(-1, 1, Y), np.linspace(-1, 1, X), indexing="ij"
    )
    frames = [np.exp(-8 * ((zz - 0.05 * t) ** 2 + yy**2 + (xx + 0.04 * t) ** 2)) for t in range(T)]
    image_4d = ScalarImage(
        np.stack(frames, axis=-1),  # time as the trailing series axis
        dimensions=[1.6, 2.4, 2.4],
        series=True,
        dim=3,
        time=[float(10 * t) for t in range(T)],
        device=device,
    )
    report(f"dimensions of the space-time image: {image_4d.dimensions}")
    report(f"the time series holds {image_4d.time_num} images")

    # One 3-D time slice.
    report("3d slice shape:", image_4d.time_slice(9).shape)

    # A time interval.
    interval = image_4d.time_interval(slice(8, 10))
    report("interval length:", interval.time_num)

    # Restrict to an ROI in the z-direction.
    nz = image_4d.num_voxels[0]
    roi = interval.subregion((slice(nz // 4, 3 * nz // 4), slice(0, None), slice(0, None)))
    report("roi shape:", roi.shape)

    # Vertically average the z-direction: a 2-D-in-space series.
    reduced = AxisReduction(axis="z", dim=3)(roi)
    report("reduced series:", reduced.shape, "space_dim:", reduced.space_dim)
    if reduced.space_dim != 2:
        raise RuntimeError(f"reduced series has space_dim {reduced.space_dim}, want 2")
    return {"lines": report.lines}


if __name__ == "__main__":
    cli(main)
