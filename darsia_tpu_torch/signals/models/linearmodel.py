"""Linear signal model.

Counterpart of :mod:`darsia_tpu.signals.models.linearmodel` (``LinearModel``).
"""

from __future__ import annotations

import torch

__all__ = ["LinearModel", "Model"]


class Model:
    """Base model: callable on tensors or Images (same return type)."""

    def __call__(self, img, *args):
        if hasattr(img, "img"):
            out = img.copy()
            out.img = self.call_array(img.img, *args)
            return out
        return self.call_array(img, *args)

    def call_array(self, signal: torch.Tensor, *args) -> torch.Tensor:
        raise NotImplementedError


class LinearModel(Model):
    """Affine conversion ``scaling * signal + offset``."""

    def __init__(self, key: str = "", **kwargs) -> None:
        self._scaling = kwargs.get(key + "scaling", 1.0)
        self._offset = kwargs.get(key + "offset", 0.0)

    def call_array(self, img: torch.Tensor) -> torch.Tensor:
        return self._scaling * img + self._offset
