"""Experimental color correction (EOTF + polynomial matching).

Counterpart of
:mod:`darsia_tpu.corrections.color.experimentalcolorcorrection`: decode the
gamma, match the checker's swatches to the classic checker by a polynomial
correction, re-encode.  The checker is located by a user-provided ROI (tuple
of slices).  The frame is decoded and corrected on its device; only the
checker crop, shaped and resized there, is read to the host for the swatch
k-means (as :class:`~.colorcorrection.ColorCorrection` does).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...ops.polynomial_color import colour_correction
from ...utils.dtype import convert_dtype
from ...utils.npz import load_npz
from ..base import BaseCorrection
from .colorcorrection import ColorCheckerAfter2014, CustomColorChecker

__all__ = ["EOTF", "ExperimentalColorCorrection"]


class EOTF:
    """Electro-optical transfer function (sRGB-like gamma 2.2)."""

    def __init__(self) -> None:
        self.gamma = 2.2

    def adjust(self, image: torch.Tensor) -> torch.Tensor:
        """Decode: gamma-expand to linear light."""
        return image.to(torch.float32).clamp(0.0, 1.0) ** self.gamma

    def inverse_approx(self, image: torch.Tensor) -> torch.Tensor:
        """Encode: gamma-compress back to display space."""
        return image.to(torch.float32).clamp(0.0, 1.0) ** (1.0 / self.gamma)


class ExperimentalColorCorrection(BaseCorrection):
    """EOTF-decoded polynomial color correction against the classic checker."""

    def __init__(self, roi: Optional[tuple] = None, verbosity: bool = False, **kwargs) -> None:
        self.roi = roi
        self.verbosity = verbosity
        self.eotf = EOTF()
        self.colorchecker = ColorCheckerAfter2014()

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        if img.dtype in (torch.uint8, torch.uint16):
            img = convert_dtype(img, torch.float32)
        decoded = self.eotf.adjust(img)
        checker_crop = decoded[self.roi] if self.roi is not None else decoded
        swatches = CustomColorChecker(image=checker_crop).swatches_rgb
        reference = self.eotf.adjust(torch.from_numpy(self.colorchecker.swatches_rgb)).numpy()
        corrected = colour_correction(
            decoded,
            swatches.reshape((24, 3), order="F"),
            reference.reshape((24, 3), order="F"),
        )
        return self.eotf.inverse_approx(corrected)

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        roi_serial = None if self.roi is None else [[s.start, s.stop] for s in self.roi]
        np.savez(
            path,
            class_name=type(self).__name__,
            roi=np.array(roi_serial if roi_serial else []),
        )

    def load(self, path: Path) -> None:
        roi = load_npz(path)["roi"]
        self.roi = tuple(slice(int(r[0]), int(r[1])) for r in roi) if roi.size else None
