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
        self.num_parameters = 2
        self.volumes = None

    def update(self, scaling=None, offset=None) -> None:
        if scaling is not None:
            self._scaling = scaling
        if offset is not None:
            self._offset = offset

    def update_model_parameters(self, parameters, dofs=None) -> None:
        if dofs is None or dofs == ["all"] or dofs == "all" or (
            isinstance(dofs, (list, set)) and set(dofs) == {"scaling", "offset"}
        ):
            self.update(scaling=parameters[0], offset=parameters[1])
        elif set(dofs) == {"scaling"}:
            self.update(scaling=parameters[0])
        elif set(dofs) == {"offset"}:
            self.update(offset=parameters[0])
        else:
            raise ValueError(f"Unknown dof {dofs}.")

    def call_array(self, img: torch.Tensor) -> torch.Tensor:
        return self._scaling * img + self._offset
