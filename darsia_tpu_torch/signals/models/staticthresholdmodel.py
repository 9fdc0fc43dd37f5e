"""Static threshold model (homogeneous or per label).

Counterpart of :mod:`darsia_tpu.signals.models.staticthresholdmodel`.  Per
label, the JAX package fills host threshold fields label by label on every
call; here each pixel's label position is kept once per device
(:class:`~darsia_tpu_torch.signals.models.basemodel.LabelIndex`) and a call
gathers the per-label bounds and compares once.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ...image.image import as_tensor
from .basemodel import LabelIndex, Model

__all__ = ["StaticThresholdModel"]


def _float32(img) -> torch.Tensor:
    """``img`` as a float32 tensor: the JAX package compares in float32 (a
    Python threshold takes the array's float32; float64 input becomes
    float32)."""
    img = as_tensor(img)
    return img if img.dtype == torch.float32 else img.to(torch.float32)


class StaticThresholdModel(Model):
    """Threshold the signal into a boolean (or float) mask."""

    def __init__(
        self,
        threshold_lower: Union[float, list] = 0.0,
        threshold_upper: Optional[Union[float, list]] = None,
        labels=None,
        return_float: bool = False,
    ) -> None:
        self.return_float = return_float
        if labels is None:
            self._is_homogeneous = True
            self._threshold_lower = float(threshold_lower)
            self._threshold_upper = (
                None if threshold_upper is None else float(threshold_upper)
            )
            self.num_parameters = 2
        else:
            self._is_homogeneous = False
            self._label_index = LabelIndex(labels)
            self._unique_labels = self._label_index.unique
            num_labels = len(self._unique_labels)
            self._threshold_lower = self._expand(threshold_lower, num_labels)
            self._threshold_upper = (
                None
                if threshold_upper is None
                else self._expand(threshold_upper, num_labels)
            )
            self.num_parameters = 2 * num_labels

    @staticmethod
    def _expand(value, num_labels):
        if isinstance(value, (list, np.ndarray)):
            arr = np.asarray(value, dtype=float)
            assert len(arr) == num_labels
            return arr
        return float(value) * np.ones(num_labels, dtype=float)

    def _bounds(self, device) -> tuple:
        """(lower, upper) as float32 scalars (homogeneous) or fields gathered
        from the per-label values; upper None without an upper bound."""
        if self._is_homogeneous:
            lower = torch.tensor(self._threshold_lower, dtype=torch.float32, device=device)
            upper = self._threshold_upper
            if upper is not None:
                upper = torch.tensor(upper, dtype=torch.float32, device=device)
            return lower, upper
        lower = self._label_index.gather(self._threshold_lower, device)
        upper = self._threshold_upper
        if upper is not None:
            upper = self._label_index.gather(upper, device)
        return lower, upper

    def __call__(self, img, mask=None):
        if hasattr(img, "img"):
            out = img.copy()
            out.img = self.__call__(img.img, mask)
            return out
        img = _float32(img)
        lower, upper = self._bounds(img.device)
        result = img > lower
        if upper is not None:
            result = result & (img < upper)
        if mask is not None:
            return result & as_tensor(mask, img.device).to(torch.bool)
        if self.return_float:
            return result.to(torch.float32)
        return result

    def update_model_parameters(self, parameters, dofs=None) -> None:
        parameters = np.asarray(parameters)
        if self._is_homogeneous:
            self._threshold_lower = float(parameters[0])
            if len(parameters) > 1 and self._threshold_upper is not None:
                self._threshold_upper = float(parameters[1])
        else:
            n = len(self._unique_labels)
            self._threshold_lower = parameters[:n]
            if self._threshold_upper is not None and len(parameters) >= 2 * n:
                self._threshold_upper = parameters[n : 2 * n]
