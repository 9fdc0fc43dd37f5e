"""Distances between mass distributions: W1 (Beckmann) against EMD.

The port of the JAX package's ``examples/distances.py``: two Gaussian blobs
on a 64x64 grid, normalised to unit mass; W1 by the Newton solver (Jacobi
CG) and the earth mover's distance (OpenCV on the host, 4096-point
signatures: minutes on one core).  ``emd=False`` leaves the EMD and its
line out.
"""

from __future__ import annotations

import numpy as np

from .. import EMD, Geometry, Image, wasserstein_distance
from ..image.image import card_unless
from . import Report, cli


def main(device=None, fast: bool = False, emd: bool = True) -> dict:
    device = card_unless(device, "the distances example")
    report = Report()
    n = 64
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")

    def blob(cy, cx):
        return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.01)

    meta = {"width": 1.0, "height": 1.0, "scalar": True}
    src = Image(blob(0.3, 0.3), device=device, **meta)
    dst = Image(blob(0.7, 0.6), device=device, **meta)

    # Unit mass, so that W1 and the internally normalised EMD compare.
    geometry = Geometry(**src.shape_metadata())
    src.img = src.img / float(geometry.integrate(src))
    dst.img = dst.img / float(geometry.integrate(dst))

    # linear_solver="cg" keeps the example light (Jacobi-CG at 64^2).
    w1 = float(
        wasserstein_distance(
            src,
            dst,
            method="newton",
            options={"num_iter": 100, "tol_residual": 1e-6, "linear_solver": "cg"},
        )
    )
    report(f"W1 (Beckmann/Newton): {w1:.6f}")

    result = {"w1": w1, "emd": None}
    if emd:
        result["emd"] = float(EMD()(src, dst))
        report(f"EMD (cv2):            {result['emd']:.6f}")

    # The displacement is (0.4, 0.3): |d| = 0.5 per unit mass.
    report("analytic |d| = 0.5")
    return {"lines": report.lines, **result}


if __name__ == "__main__":
    cli(main)
