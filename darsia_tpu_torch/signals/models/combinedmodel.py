"""Sequential composition of models.

Counterpart of :mod:`darsia_tpu.signals.models.combinedmodel`.
"""

from __future__ import annotations

import inspect

import numpy as np

from .basemodel import Model

__all__ = ["CombinedModel"]


class CombinedModel(Model):
    """Apply a chain of models (any callables on tensors or Images) in order."""

    def __init__(self, models: list) -> None:
        self.models = models
        self.num_parameters = sum(getattr(m, "num_parameters", 0) for m in models)

    def __call__(self, img, *args):
        result = img
        for model in self.models:
            result = model(result, *args) if _accepts_args(model) else model(result)
        return result

    def call_array(self, signal, *args):
        return self.__call__(signal, *args)

    def update_model_parameters(self, parameters, dofs=None) -> None:
        parameters = np.asarray(parameters)
        offset = 0
        for model in self.models:
            n = getattr(model, "num_parameters", 0)
            if n:
                model.update_model_parameters(parameters[offset : offset + n], dofs)
                offset += n

    def __getitem__(self, pos_model: int):
        return self.models[pos_model]


def _accepts_args(model) -> bool:
    """Whether the model's call takes more than the signal."""
    try:
        sig = inspect.signature(model.__call__)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) > 1
