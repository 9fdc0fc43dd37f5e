"""Linear signal model.

Counterpart of :mod:`darsia_tpu.signals.models.linearmodel` (``LinearModel``).
"""

from __future__ import annotations

import torch

from .basemodel import Model

__all__ = ["LinearModel", "Model"]


class LinearModel(Model):
    """Affine conversion ``scaling * signal + offset``."""

    def __init__(self, key: str = "", **kwargs) -> None:
        self._scaling = kwargs.get(key + "scaling", 1.0)
        self._offset = kwargs.get(key + "offset", 0.0)

    def call_array(self, img: torch.Tensor) -> torch.Tensor:
        return self._scaling * img + self._offset
