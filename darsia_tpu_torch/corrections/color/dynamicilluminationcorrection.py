"""Dynamic illumination correction: a global per-image rescaling.

Counterpart of
:mod:`darsia_tpu.corrections.color.dynamicilluminationcorrection`.  Setup
extracts characteristic baseline colors from sample patches; each corrected
image is rescaled by the per-channel factors that bring its sample colors
closest to them (closed-form least squares).  Only the sample patches are
copied to the host (the JAX package reads the whole image); the rescaling
runs on the image's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np
import torch

from ...image.image import as_numpy
from ...utils.dtype import host_float32
from ...utils.extractcharacteristicdata import extract_characteristic_data
from ...utils.npz import load_npz
from ..base import BaseCorrection

__all__ = ["DynamicIlluminationCorrection"]


class _HostPatches:
    """Sample patches of an image, cut on its device and read to the host as
    float32 (integer images through float64, as the JAX package converts
    numpy images)."""

    def __init__(self, image) -> None:
        data = image.img if hasattr(image, "img") else image
        self.data = data
        self.shape = tuple(data.shape)

    def __getitem__(self, sample) -> np.ndarray:
        return host_float32(as_numpy(self.data[sample]))


class DynamicIlluminationCorrection(BaseCorrection):
    """Global per-image illumination rescaling against baseline colors."""

    def setup(self, base, samples: list[tuple[slice, ...]], colorspace: Literal["rgb"] = "rgb") -> None:
        """Extract the characteristic baseline colors of ``samples``."""
        self.colorspace = colorspace
        self.samples = samples
        self.base_colors = self.extract_characteristic_colors(base)

    def extract_characteristic_colors(self, image) -> np.ndarray:
        return extract_characteristic_data(signal=_HostPatches(image), samples=self.samples)

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "base_colors"):
            return img
        colors = self.extract_characteristic_colors(img)
        if len(colors) == 0:
            return img
        # Closed-form per-channel scaling: min_s sum (s c - b)^2.
        c = np.asarray(colors, dtype=float)
        b = np.asarray(self.base_colors, dtype=float)
        denom = np.sum(c * c, axis=0)
        scaling = np.where(denom > 0, np.sum(c * b, axis=0) / denom, 1.0)
        return img * torch.as_tensor(scaling, dtype=torch.float32, device=img.device)

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        samples = [[[s[0].start, s[0].stop], [s[1].start, s[1].stop]] for s in self.samples]
        np.savez(
            path,
            class_name=type(self).__name__,
            base_colors=self.base_colors,
            samples=np.array(samples),
            colorspace=self.colorspace,
        )

    def load(self, path: Path) -> None:
        data = load_npz(path)
        self.base_colors = data["base_colors"]
        self.colorspace = str(data["colorspace"])
        self.samples = [
            (slice(int(s[0][0]), int(s[0][1])), slice(int(s[1][0]), int(s[1][1])))
            for s in data["samples"]
        ]
