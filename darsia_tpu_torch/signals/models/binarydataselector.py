"""Criterion-based selection of connected mask regions.

Counterpart of :mod:`darsia_tpu.signals.models.binarydataselector`.  As
there, the selector runs on the host: the connected components and the
per-region maxima and minima are ``scipy.ndimage``'s, on numpy arrays (a
tensor given is copied to the host); the result is a numpy mask.  The
gradient modulus and the extra colour reduction run on CPU tensors.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional

import numpy as np
import torch
from scipy import ndimage

from ...image.image import as_numpy
from ...utils.derivatives import forward_diff
from ..reduction.signalreduction import MonochromaticReduction

__all__ = [
    "BaseCriterion",
    "BinaryDataSelector",
    "CombinedCriterion",
    "GradientModulusCriterion",
    "RelativeValueCriterion",
    "TransformedValueCriterion",
    "ValueCriterion",
]


def _host_tensor(array) -> torch.Tensor:
    """``array`` as a CPU tensor (a tensor is copied to the host)."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(array))


class BaseCriterion:
    """Abstract per-region acceptance criterion."""

    type = "volume"

    def bind(self, signal, unprocessed_signal) -> None:
        self.signal = as_numpy(signal)

    @abc.abstractmethod
    def accept_regions(self, labels: np.ndarray, num: int) -> np.ndarray:
        """Boolean acceptance per label id (1..num)."""


class ValueCriterion(BaseCriterion):
    """Accept regions whose max signal value exceeds a threshold."""

    def __init__(self, threshold: float) -> None:
        self.threshold = threshold

    def accept_regions(self, labels, num):
        maxima = ndimage.maximum(self.signal, labels, index=np.arange(1, num + 1))
        return np.atleast_1d(maxima) > self.threshold


class RelativeValueCriterion(BaseCriterion):
    """Accept regions with max > threshold * min."""

    def __init__(self, threshold: float) -> None:
        self.threshold = threshold

    def accept_regions(self, labels, num):
        idx = np.arange(1, num + 1)
        maxima = np.atleast_1d(ndimage.maximum(self.signal, labels, index=idx))
        minima = np.atleast_1d(ndimage.minimum(self.signal, labels, index=idx))
        return maxima > self.threshold * minima


class TransformedValueCriterion(BaseCriterion):
    """Value criterion on a transform of the unprocessed signal (the
    transformation is called with a CPU tensor)."""

    def __init__(self, transformation: Callable, threshold: float) -> None:
        self.transformation = transformation
        self.threshold = threshold

    def bind(self, signal, unprocessed_signal) -> None:
        self.signal = as_numpy(self.transformation(_host_tensor(unprocessed_signal)))

    def accept_regions(self, labels, num):
        maxima = ndimage.maximum(self.signal, labels, index=np.arange(1, num + 1))
        return np.atleast_1d(maxima) > self.threshold


class GradientModulusCriterion(BaseCriterion):
    """Accept regions whose boundary gradient modulus is large."""

    type = "contour"

    def __init__(self, threshold: Optional[float] = None, key: str = "", **kwargs):
        self.threshold = threshold

    def bind(self, signal, unprocessed_signal) -> None:
        s = _host_tensor(signal).to(torch.float32)
        dx = forward_diff(s, 0, 2)
        dy = forward_diff(s, 1, 2)
        self.signal = torch.sqrt(dx**2 + dy**2).numpy()

    def accept_regions(self, labels, num):
        # The rim of each region: where the 3x3 erosion of the labels differs.
        boundary = labels != ndimage.grey_erosion(labels, size=(3, 3))
        grad = np.where(boundary, self.signal, 0.0)
        maxima = ndimage.maximum(grad, labels, index=np.arange(1, num + 1))
        return np.atleast_1d(maxima) > self.threshold


class CombinedCriterion(BaseCriterion):
    """All sub-criteria must accept."""

    def __init__(self, criteria: list) -> None:
        self.criteria = criteria
        self.type = criteria[0].type if criteria else "volume"

    def bind(self, signal, unprocessed_signal) -> None:
        for criterion in self.criteria:
            criterion.bind(signal, unprocessed_signal)

    def accept_regions(self, labels, num):
        accepts = [c.accept_regions(labels, num) for c in self.criteria]
        return np.logical_and.reduce(accepts)


class BinaryDataSelector:
    """Keep only the connected mask regions that satisfy a criterion."""

    def __init__(self, criterion: Optional[BaseCriterion] = None, key: str = "", **kwargs):
        if criterion is not None:
            self.criterion = criterion
        else:
            criterion_key = kwargs.get(key + "criterion")
            threshold = kwargs.get(key + "threshold")
            if criterion_key == "value":
                self.criterion = ValueCriterion(threshold)
            elif criterion_key == "relative value":
                self.criterion = RelativeValueCriterion(threshold)
            elif criterion_key == "value/value extra color":
                value_criterion = ValueCriterion(threshold[0])
                color = kwargs.get(key + "extra color")
                transformation = MonochromaticReduction(color=color)
                extra = TransformedValueCriterion(transformation, threshold[1])
                self.criterion = CombinedCriterion([value_criterion, extra])
            elif criterion_key == "gradient modulus":
                self.criterion = GradientModulusCriterion(threshold)
            else:
                raise ValueError(f"Criterion type {criterion_key} not supported.")
        self.type = getattr(self.criterion, "type", "volume")

    def __call__(self, signal, mask, unprocessed_signal) -> np.ndarray:
        self.criterion.bind(signal, unprocessed_signal)
        mask = as_numpy(mask).astype(bool)
        labels, num = ndimage.label(mask)
        if num == 0:
            return np.zeros_like(mask)
        accept = self.criterion.accept_regions(labels, num)
        keep = np.concatenate([[False], accept])
        return keep[labels]
