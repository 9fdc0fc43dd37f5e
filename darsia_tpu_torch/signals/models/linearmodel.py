"""Linear signal models: scaling, affine, and per-label affine.

Counterpart of :mod:`darsia_tpu.signals.models.linearmodel`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...image.image import as_tensor
from .basemodel import LabelIndex, Model

__all__ = ["HeterogeneousLinearModel", "LinearModel", "Model", "ScalingModel"]


class ScalingModel(Model):
    """Plain scaling of the signal."""

    def __init__(self, key: str = "", **kwargs) -> None:
        self._scaling = kwargs.get(key + "scaling", 1.0)
        self.num_parameters = 1
        self.volumes = None

    def update(self, scaling: Optional[float] = None) -> None:
        if scaling is not None:
            self._scaling = scaling

    def update_model_parameters(self, parameters, dofs=None) -> None:
        if dofs is None or dofs == "all" or set(dofs) == {"scaling"}:
            self.update(scaling=parameters[0])
        else:
            raise ValueError(f"Unknown dof {dofs}.")

    def call_array(self, img: torch.Tensor) -> torch.Tensor:
        return self._scaling * img


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


class HeterogeneousLinearModel(Model):
    """Per-label affine conversion ``scaling[label] * signal + offset[label]``.

    The two per-label tables become fields by one gather each, built once
    per device and again only after :meth:`update`.
    """

    def __init__(self, labels, key: str = "", **kwargs) -> None:
        self._label_index = LabelIndex(labels)
        self.unique_labels = self._label_index.unique
        self.num_labels = len(self.unique_labels)
        scaling = kwargs.get(key + "scaling", 1.0)
        offset = kwargs.get(key + "offset", 0.0)
        self._scaling = (
            np.full(self.num_labels, scaling, dtype=float)
            if np.isscalar(scaling)
            else np.asarray(scaling, dtype=float)
        )
        self._offset = (
            np.full(self.num_labels, offset, dtype=float)
            if np.isscalar(offset)
            else np.asarray(offset, dtype=float)
        )
        self.num_parameters = 2 * self.num_labels
        self.volumes = None
        self._fields_on: dict = {}

    def _fields(self, device) -> tuple:
        device = torch.device(device)
        fields = self._fields_on.get(device)
        if fields is None:
            fields = self._fields_on[device] = (
                self._label_index.gather(self._scaling, device),
                self._label_index.gather(self._offset, device),
            )
        return fields

    def update(self, scaling=None, offset=None) -> None:
        if scaling is not None:
            self._scaling = np.asarray(scaling, dtype=float)
        if offset is not None:
            self._offset = np.asarray(offset, dtype=float)
        self._fields_on = {}

    def update_model_parameters(self, parameters, dofs=None) -> None:
        parameters = np.asarray(parameters)
        if dofs is None or dofs == "all":
            self.update(
                scaling=parameters[: self.num_labels],
                offset=parameters[self.num_labels : 2 * self.num_labels],
            )
        elif set(dofs) == {"scaling"}:
            self.update(scaling=parameters[: self.num_labels])
        elif set(dofs) == {"offset"}:
            self.update(offset=parameters[: self.num_labels])
        else:
            raise ValueError(f"Unknown dof {dofs}.")

    def call_array(self, img: torch.Tensor) -> torch.Tensor:
        img = as_tensor(img)
        scaling_field, offset_field = self._fields(img.device)
        return scaling_field * img + offset_field
