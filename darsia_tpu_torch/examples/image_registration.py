"""Image registration: recover a deformation between two images.

The port of the JAX package's ``examples/image_registration.py`` (which
mirrors the reference's): ``ImageRegistration`` of the first CO2 frame onto
the second, then its dense displacement field.
"""

from __future__ import annotations

from .. import ImageRegistration
from ..image.image import card_unless
from . import Report, cli
from ._data import load_co2_series


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the image registration example")
    report = Report()
    images = load_co2_series(shape=(128, 192) if fast else (256, 384), device=device)
    img_src, img_dst = images[0], images[1]

    registration = ImageRegistration(img_dst, N_patches=[4, 6] if fast else [8, 12], rtol=0.05)
    transformed = registration(img_src)
    report("registered image:", tuple(transformed.shape))

    displacement = registration.displacement()
    max_disp = float(displacement.abs().max())
    report("displacement field:", tuple(displacement.shape), "max |disp| [m]:", max_disp)
    return {"lines": report.lines, "max_disp": max_disp}


if __name__ == "__main__":
    cli(main)
