"""Signal reductions: multichromatic -> scalar signals.

Counterpart of :mod:`darsia_tpu.signals.reduction.signalreduction` (the gray
reduction; the other colors are not ported yet).
"""

from __future__ import annotations

import torch

from ...ops.color import rgb_to_gray

__all__ = ["MonochromaticReduction", "SignalReduction"]


class SignalReduction:
    """Identity reduction of an (assumed scalar) signal."""

    def __call__(self, img):
        return img


class MonochromaticReduction(SignalReduction):
    """Reduce RGB signals to a scalar channel; only ``color="gray"`` so far."""

    def __init__(self, **kwargs) -> None:
        self.color = kwargs.get("color", "gray")
        if self.color != "gray":
            raise NotImplementedError(f"color {self.color!r} is not ported yet")

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return rgb_to_gray(img.to(torch.float32))
