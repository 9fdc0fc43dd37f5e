"""Signal reductions: multichromatic -> scalar signals.

Counterpart of :mod:`darsia_tpu.signals.reduction.signalreduction`; the hsv
reduction follows the skimage convention with hue in [0, 1].
"""

from __future__ import annotations

import torch

from ...ops.color import rgb_to_gray, rgb_to_hsv

__all__ = ["MonochromaticReduction", "SignalReduction"]


class SignalReduction:
    """Identity reduction of an (assumed scalar) signal."""

    def __call__(self, img):
        return img


class MonochromaticReduction(SignalReduction):
    """Reduce RGB signals to a scalar channel or feature.

    Colors: gray, red, green, blue, red+green, negative-key, hsv (value masked
    by hue/saturation bounds), a callable, or "" (identity).
    """

    def __init__(self, **kwargs) -> None:
        self.color = kwargs.get("color", "gray")
        self.verbosity = kwargs.get("verbosity", 0)
        if self.color == "hsv":
            self.hue_lower_bound = kwargs.get("hue lower bound", 0.0)
            self.hue_upper_bound = kwargs.get("hue upper bound", 360.0)
            self.saturation_lower_bound = kwargs.get("saturation lower bound", 0.0)
            self.saturation_upper_bound = kwargs.get("saturation upper bound", 1.0)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if self.color == "hsv":
            hsv = rgb_to_hsv(img.to(torch.float32))
            hue, sat, value = hsv[..., 0] / 360.0, hsv[..., 1], hsv[..., 2]
            mask = (
                (hue > self.hue_lower_bound)
                & (hue < self.hue_upper_bound)
                & (sat > self.saturation_lower_bound)
                & (sat < self.saturation_upper_bound)
            )
            return torch.where(mask, value, torch.zeros_like(value))
        if self.color == "gray":
            return rgb_to_gray(img.to(torch.float32))
        if self.color in ("red", "green", "blue"):
            return img[..., ("red", "green", "blue").index(self.color)]
        if self.color == "red+green":
            return img[..., 0] + img[..., 1]
        if self.color == "negative-key":
            return 1 - torch.amin(1 - img, dim=-1)
        if callable(self.color):
            return self.color(img)
        if self.color == "":
            return img
        raise ValueError(f"Mono-colored space {self.color} not supported.")
