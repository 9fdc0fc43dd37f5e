"""Wasserstein-1 distance of a square split into two.

The port of the JAX package's ``examples/wasserstein_split_square.py``: the
10x10 anchor problem (exact distance 0.379543951823 on the coarse grid),
refined 2^4 times to 160x160 (2^3 to 80x80 in fast mode) by conservative
nearest refinement, solved by the Newton Beckmann solver.
"""

from __future__ import annotations

import time

import numpy as np

from .. import Geometry, Image, Resize, wasserstein_distance
from ..image.image import card_unless
from . import Report, cli
from .wasserstein import ANCHOR


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the split-square example")
    report = Report()
    rows = cols = 10
    src_square = np.zeros((rows, cols), dtype=float)
    src_square[2:5, 2:5] = 1
    dst_squares = np.zeros((rows, cols), dtype=float)
    dst_squares[1:3, 1:2] = 1
    dst_squares[4:7, 7:9] = 1
    meta = {"width": 1, "height": 1, "space_dim": 2, "scalar": True}
    src_image = Image(src_square, device=device, **meta)
    dst_image = Image(dst_squares, device=device, **meta)

    # Rescale to unit mass.
    geometry = Geometry(**src_image.shape_metadata())
    src_image.img = src_image.img / geometry.integrate(src_image)
    dst_image.img = dst_image.img / geometry.integrate(dst_image)

    # Refine 2^4 times (fast: 2^3), conservatively by nearest refinement.
    lvl = 3 if fast else 4
    resize = Resize(
        **{"resize shape": (rows * 2**lvl, cols * 2**lvl), "resize interpolation": "inter_nearest"}
    )
    src_image = resize(src_image)
    dst_image = resize(dst_image)

    options = {
        "num_iter": 200,
        "tol_residual": 1e-3,
        "tol_increment": 1e-3,
        "tol_distance": 1e-3,
        "L": 1e9,
        "return_info": True,
    }
    tic = time.time()
    distance, info = wasserstein_distance(src_image, dst_image, method="newton", options=options)
    elapsed = time.time() - tic
    distance = float(distance)
    iterations = info["number_iterations"] + 1
    report(
        f"W1 (newton, 160x160): {distance:.6f} "
        f"(coarse-grid reference 0.379544) in {elapsed:.2f}s, "
        f"{iterations} iterations"
    )
    if not abs(distance - ANCHOR) < 0.02:
        raise RuntimeError(f"W1 {distance} is not within 0.02 of {ANCHOR}")
    return {"lines": report.lines, "distance": distance, "iterations": iterations, "solve_s": elapsed}


if __name__ == "__main__":
    cli(main)
