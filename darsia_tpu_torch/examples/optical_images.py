"""Photographs: curvature correction and colour-space conversions.

The port of the JAX package's ``examples/optical_images.py`` (synthetic
branch): a bulge-only curvature correction of the baseline, the same
correction of the baseline with a grid drawn over it, then trichromatic and
monochromatic conversions.  The baseline is an ``OpticalImage`` already
(``_data``), where the JAX example calls ``to_optical``, which no class
defines (reference fault 1).
"""

from __future__ import annotations

from .. import CurvatureCorrection, OpticalImage
from ..image.image import card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the optical images example")
    report = Report()
    original_image = load_baseline(shape=(270, 512), device=device)
    curvature_correction = CurvatureCorrection(config={"bulge": {"vertical_bulge": -1e-7}})
    corrected_image = OpticalImage(
        img=original_image.img, transformations=[curvature_correction], width=2.8, height=1.5
    )
    report("corrected image shape:", corrected_image.shape)

    # The effect of the correction on a grid overlay.
    original_with_grid = original_image.add_grid(origin=[0.0, 0.0], dx=0.1, dy=0.1)
    corrected_with_grid = OpticalImage(
        img=original_with_grid.img,
        transformations=[curvature_correction],
        width=2.8,
        height=1.5,
        color_space="RGB",
    )
    report("grid-corrected shape:", corrected_with_grid.shape)

    # Colour-space conversions, reduced on the device.
    hsv_image = corrected_image.to_trichromatic("hsv", return_image=True)
    hsv_range = (float(hsv_image.img.min()), float(hsv_image.img.max()))
    report("hsv range:", *hsv_range)

    bgr_image = corrected_image.copy()
    bgr_image.to_trichromatic("bgr")
    report("bgr color space:", bgr_image.color_space)

    red_image = corrected_image.to_monochromatic("red")
    report("red channel shape:", red_image.shape, "scalar:", red_image.scalar)

    gray_image = corrected_image.to_monochromatic("gray")
    report("gray dtype:", gray_image.as_numpy().dtype)
    return {"lines": report.lines, "hsv_range": hsv_range}


if __name__ == "__main__":
    cli(main)
