"""Fixed translation correction.

Counterpart of :mod:`darsia_tpu.corrections.shape.translation` (the
correction; the phase-correlation estimator class is not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.warp import identity_grid, warp_backend
from ..base import BaseCorrection

__all__ = ["TranslationCorrection", "translate_array"]


def translate_array(img: torch.Tensor, translation_xy, order: int = 1) -> torch.Tensor:
    """Shift an image by (dx, dy) = (col, row): ``output(p) = input(p - t)``."""
    dx, dy = float(translation_xy[0]), float(translation_xy[1])
    coords = identity_grid(tuple(img.shape[:2]), img.device)
    shift = torch.tensor([dy, dx], dtype=torch.float32, device=img.device)
    coords = coords - shift.reshape(2, 1, 1)
    max_disp = int(np.ceil(max(abs(dx), abs(dy)))) + 1
    out = warp_backend(img.to(torch.float32), coords, order=order, max_disp=max_disp)
    if not img.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(img.dtype)


class TranslationCorrection(BaseCorrection):
    """Apply a fixed translation (x, y) = (col, row)."""

    def __init__(self, translation=None) -> None:
        self.translation = np.asarray(
            np.zeros(2) if translation is None else translation, dtype=float
        )

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        return translate_array(img, self.translation)

    def pullback_field(self, input_shape: tuple, device):
        """Static pull-back field: identity minus the translation."""
        shape = tuple(int(s) for s in input_shape)
        shift = torch.tensor(
            [-float(self.translation[1]), -float(self.translation[0])],
            dtype=torch.float32,
            device=device,
        )
        return identity_grid(shape, device) + shift.reshape(2, 1, 1), {}
