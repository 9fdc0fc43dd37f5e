"""Deformation correction: warp images by a registered deformation.

Counterpart of :mod:`darsia_tpu.corrections.shape.deformation`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...image.image import Image
from ..base import BaseCorrection

__all__ = ["DeformationCorrection"]


class DeformationCorrection(BaseCorrection):
    """Correct images by registering them onto a baseline."""

    def __init__(self, base: Image, config: Optional[dict] = None) -> None:
        from ...analysis.imageregistration import ImageRegistration

        self.base = base
        self.image_registration = ImageRegistration(base, **(config or {}))

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        probe = type(self.base)(img=img, **self.base.metadata())
        return self.image_registration(probe).img
