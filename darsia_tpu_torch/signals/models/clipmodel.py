"""Clip model.

Counterpart of :mod:`darsia_tpu.signals.models.clipmodel`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...image.image import as_tensor
from .basemodel import Model

__all__ = ["ClipModel"]


class ClipModel(Model):
    """Clip the signal to [min_value, max_value]."""

    def __init__(
        self,
        min_value: Optional[float] = None,
        max_value: Optional[float] = None,
        key: Optional[str] = None,
        **kwargs,
    ) -> None:
        if key is None:
            self._min_value = min_value
            self._max_value = max_value
        else:
            self._min_value = kwargs.get(key + "_min_value", None)
            self._max_value = kwargs.get(key + "_max_value", None)
        if self._min_value is None and self._max_value is None:
            raise ValueError("at least one of min_value or max_value must be provided")
        self.num_parameters = 2

    def update(self, min_value=None, max_value=None) -> None:
        if min_value is not None:
            self._min_value = min_value
        if max_value is not None:
            self._max_value = max_value

    def update_model_parameters(self, parameters, dofs=None) -> None:
        if dofs is None or dofs == "all" or set(dofs) == {"min_value", "max_value"}:
            self.update(min_value=parameters[0], max_value=parameters[1])
        elif set(dofs) == {"min_value"}:
            self.update(min_value=parameters[0])
        elif set(dofs) == {"max_value"}:
            self.update(max_value=parameters[0])
        else:
            raise ValueError("invalid list of degrees of freedom")

    def call_array(self, img) -> torch.Tensor:
        lo = None if self._min_value is None else float(self._min_value)
        hi = None if self._max_value is None else float(self._max_value)
        return torch.clamp(as_tensor(img), min=lo, max=hi)
