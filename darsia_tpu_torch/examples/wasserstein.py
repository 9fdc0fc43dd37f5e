"""Wasserstein-1 distances between mass distributions (Beckmann form).

The port of the JAX package's ``examples/wasserstein.py``: the 10x10
two-squares problem (exact distance 0.379543951823), masses normalised to
1 by physical integration, solved by Newton and Bregman, and
cross-checked by the earth mover's distance (OpenCV, on the host).
"""

from __future__ import annotations

import numpy as np

from .. import EMD, Geometry, Image, wasserstein_distance
from ..image.image import card_unless
from . import Report, cli

ANCHOR = 0.379543951823


def unit_mass_squares(device) -> tuple:
    """The anchor problem: a 3x3 square and a 2x1 + 3x2 split on the unit
    square, each of physical mass 1, on ``device``."""
    src = np.zeros((10, 10))
    src[2:5, 2:5] = 1.0
    dst = np.zeros((10, 10))
    dst[1:3, 1:2] = 1.0
    dst[4:7, 7:9] = 1.0
    meta = {"width": 1.0, "height": 1.0, "scalar": True}
    img_src, img_dst = Image(src, device=device, **meta), Image(dst, device=device, **meta)
    geometry = Geometry(**img_src.shape_metadata())
    img_src.img = img_src.img / geometry.integrate(img_src)
    img_dst.img = img_dst.img / geometry.integrate(img_dst)
    return img_src, img_dst


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the Wasserstein example")
    report = Report()
    img_src, img_dst = unit_mass_squares(device)
    distances = {}
    for method in ("newton", "bregman"):
        distance = float(
            wasserstein_distance(
                img_src,
                img_dst,
                method=method,
                options={
                    "num_iter": 400,
                    "tol_residual": 1e-3,
                    "tol_increment": 1e-3,
                    "tol_distance": 1e-3,
                    "L": 1e9 if method == "newton" else 1.0,
                },
            )
        )
        distances[method] = distance
        report(f"W1 ({method}): {distance:.6f}  (reference 0.379544)")
        if not abs(distance - ANCHOR) < 0.02:
            raise RuntimeError(f"W1 ({method}) {distance} is not within 0.02 of {ANCHOR}")

    # The earth mover's distance (OpenCV, on the host).
    emd = float(EMD()(img_src, img_dst))
    distances["emd"] = emd
    report(f"W1 (cv2.EMD): {emd:.6f}  (reference 0.379544)")
    if not abs(emd - ANCHOR) < 0.02:
        raise RuntimeError(f"EMD {emd} is not within 0.02 of {ANCHOR}")
    return {"lines": report.lines, "distances": distances}


if __name__ == "__main__":
    cli(main)
