"""HSV spectrum analysis of image regions.

Counterpart of :mod:`darsia_tpu.utils.coloranalysis`: the HSV conversion
runs on the image's device (``ops/color.py::rgb_to_hsv``; a numpy input
goes to ``device``, the CUDA card when None), the histograms on the host
with ``np.histogram``.  Drawing the spectrum (``show_plot``) needs
matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.image import as_tensor
from ..ops.color import rgb_to_hsv
from .optional import optional_module

__all__ = ["hsv_spectrum"]


def hsv_spectrum(img, roi=None, bins: int = 100, show_plot: bool = False, device=None):
    """Histograms of hue/saturation/value over ROI(s).

    Args:
        img: RGB image (array, tensor or Image).
        roi: slice tuple or list of slice tuples.
        bins: histogram resolution.

    Returns:
        list of dicts with "hue", "saturation", "value" (histogram, edges)
        per ROI.

    """
    arr = as_tensor(img.img if hasattr(img, "img") else img, device).to(torch.float32)
    if float(arr.max()) > 1.5:
        arr = arr / 255.0
    rois = roi if isinstance(roi, list) else [roi]
    results = []
    for r in rois:
        patch = arr if r is None else arr[r]
        hsv = rgb_to_hsv(patch).cpu().numpy()
        spectrum = {}
        for i, key in enumerate(("hue", "saturation", "value")):
            values = hsv[..., i].ravel()
            rng = (0, 360.0) if key == "hue" else (0.0, 1.0)
            hist, edges = np.histogram(values, bins=bins, range=rng)
            spectrum[key] = (hist, edges)
        results.append(spectrum)
    if show_plot:  # pragma: no cover - visual
        plt = optional_module("matplotlib.pyplot", "hsv_spectrum(show_plot=True)")

        fig, axs = plt.subplots(1, 3, figsize=(12, 3))
        for i, key in enumerate(("hue", "saturation", "value")):
            for spectrum in results:
                hist, edges = spectrum[key]
                axs[i].plot(edges[:-1], hist)
            axs[i].set_title(key)
        plt.show()
    return results
