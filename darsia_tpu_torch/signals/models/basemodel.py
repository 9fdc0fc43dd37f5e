"""Model protocol: signal -> physical data conversion.

Counterpart of :mod:`darsia_tpu.signals.models.basemodel` (``Model``; the
per-label ``HeterogeneousModel`` is not ported yet).
"""

from __future__ import annotations

import torch

__all__ = ["Model"]


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

    def calibrate(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def update_model_parameters(self, parameters, dofs=None) -> None:
        raise NotImplementedError
