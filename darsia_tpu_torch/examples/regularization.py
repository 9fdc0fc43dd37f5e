"""Restoration: TV denoising (Chambolle and split Bregman) and H1.

The port of the JAX package's ``examples/regularization.py``: the gray
baseline plus seeded noise, denoised by ``tvd`` with each method, then
``H1_regularization``.
"""

from __future__ import annotations

import numpy as np

from .. import H1_regularization, tvd
from ..image.image import card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the regularization example")
    report = Report()
    image = load_baseline(shape=(135, 256), device=device).to_monochromatic("gray")
    noisy = image.copy()
    rng = np.random.default_rng(0)
    # Assigned numpy data lands on the image's device.
    noisy.img = image.img + noisy.img.new_tensor(
        0.1 * rng.standard_normal(tuple(image.shape)).astype(np.float32)
    )

    errors = {}
    for method in ("chambolle", "isotropic bregman"):
        denoised = tvd(noisy, method=method, weight=0.1, max_num_iter=100)
        errors[method] = float((denoised.img - image.img).abs().mean())
        report(f"{method}: mean abs error {errors[method]:.4f}")

    smooth = H1_regularization(noisy, mu=1.0, omega=1.0)
    report("H1 output:", tuple(smooth.shape))
    return {"lines": report.lines, "errors": errors}


if __name__ == "__main__":
    cli(main)
