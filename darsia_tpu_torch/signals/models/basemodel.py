"""Model protocol: signal -> physical data conversion.

Counterpart of :mod:`darsia_tpu.signals.models.basemodel` (``Model``,
``HeterogeneousModel``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ...image.image import as_tensor

__all__ = ["HeterogeneousModel", "LabelIndex", "Model"]


class LabelIndex:
    """The sorted distinct values of a label map and each pixel's position
    among them, kept on the device the labels were given on and copied once
    to each other device asked for.

    A per-label table of values becomes a field by one gather
    (:meth:`gather`), where the JAX package fills a host array label by
    label on every call.
    """

    def __init__(self, labels) -> None:
        labels = labels.img if hasattr(labels, "img") else labels
        if isinstance(labels, torch.Tensor):
            unique, index = torch.unique(labels, return_inverse=True)
            self.unique = unique.cpu().numpy()
        else:
            labels = np.asarray(labels)
            unique, index = np.unique(labels, return_inverse=True)
            index = torch.from_numpy(index.reshape(labels.shape))
            self.unique = unique
        self.shape = tuple(index.shape)
        self._on = {index.device: index}

    def __len__(self) -> int:
        return len(self.unique)

    def on(self, device) -> torch.Tensor:
        """Each pixel's position among the sorted labels, on ``device``."""
        device = torch.device(device)
        held = self._on.get(device)
        if held is None:
            held = self._on[device] = next(iter(self._on.values())).to(device)
        return held

    def gather(self, values, device) -> torch.Tensor:
        """The float32 field that holds ``values[i]`` on the pixels of the
        i-th label, on ``device``."""
        table = torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=torch.float32)
        return table.to(device)[self.on(device)]


class Model:
    """Base model: callable on tensors or Images (same return type); a numpy
    array goes to the card."""

    def __call__(self, img, *args):
        if hasattr(img, "img"):
            out = img.copy()
            out.img = self.call_array(img.img, *args)
            return out
        return self.call_array(as_tensor(img), *args)

    def call_array(self, signal: torch.Tensor, *args) -> torch.Tensor:
        raise NotImplementedError

    def calibrate(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def update_model_parameters(self, parameters, dofs=None) -> None:
        raise NotImplementedError


class HeterogeneousModel(Model):
    """Per-label model: each label's model runs on the whole signal and is
    blended in with ``torch.where``; ignored labels (and labels without a
    model) stay 0.

    The labels (an Image, tensor or numpy array) are kept as given and copied
    once to each device a signal comes on.
    """

    def __init__(self, model, labels, ignore_labels=None, **kwargs) -> None:
        labels = labels.img if hasattr(labels, "img") else labels
        self.labels = labels if isinstance(labels, torch.Tensor) else torch.from_numpy(labels)
        self.unique_labels = [int(label) for label in torch.unique(self.labels).tolist()]
        self.num_labels = len(self.unique_labels)
        self.ignore_labels = [int(label) for label in (ignore_labels or [])]
        # A per-label dict (calibrated models) or a prototype copied per label.
        if isinstance(model, dict):
            self.models = {int(k): v for k, v in model.items()}
        else:
            self.models = {label: copy.deepcopy(model) for label in self.unique_labels}
        self.num_parameters = sum(getattr(m, "num_parameters", 0) for m in self.models.values())
        self._on_device = {self.labels.device: self.labels}

    def labels_on(self, device) -> torch.Tensor:
        """The labels on ``device``, copied there once."""
        device = torch.device(device)
        held = self._on_device.get(device)
        if held is None:
            held = self._on_device[device] = self.labels.to(device)
        return held

    def call_array(self, signal: torch.Tensor) -> torch.Tensor:
        signal = as_tensor(signal)
        labels = self.labels_on(signal.device)
        out = None
        for label in self.unique_labels:
            model = self.models.get(label)
            if model is None or label in self.ignore_labels:
                continue
            contribution = as_tensor(model.call_array(signal)).to(torch.float32)
            if out is None:
                # The sub-model's shape (it may drop the colour axis).
                out = torch.zeros_like(contribution)
            mask = labels == label
            if mask.dim() < contribution.dim():
                mask = mask.reshape(mask.shape + (1,) * (contribution.dim() - mask.dim()))
            out = torch.where(mask, contribution, out)
        if out is None:
            out = torch.zeros(
                signal.shape[: self.labels.dim()], dtype=torch.float32, device=signal.device
            )
        return out

    def __getitem__(self, label):
        return self.models[int(label)]

    def __setitem__(self, label, value):
        self.models[int(label)] = value

    def keys(self):
        return list(self.models.keys())

    def update_model_parameters(self, parameters, dofs=None) -> None:
        offset = 0
        for label in self.unique_labels:
            model = self.models.get(label)
            if model is None:
                continue
            n = getattr(model, "num_parameters", 0)
            model.update_model_parameters(parameters[offset : offset + n], dofs)
            offset += n
