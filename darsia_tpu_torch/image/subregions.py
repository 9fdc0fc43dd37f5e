"""Quadrilateral ROI extraction under the JAX package's module path.

Counterpart of :mod:`darsia_tpu.image.subregions`: the implementation lives
with the warp engine (:mod:`darsia_tpu_torch.corrections.shape.quad`).
"""

from typing import Literal

from ..corrections.shape.quad import extract_quadrilateral_ROI

__all__ = ["InterpolationOption", "extract_quadrilateral_ROI"]

InterpolationOption = Literal["inter_nearest", "inter_linear", "inter_area"]
