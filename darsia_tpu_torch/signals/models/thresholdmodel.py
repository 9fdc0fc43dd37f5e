"""Thresholding model facade (static or dynamic, chosen by options).

Counterpart of :mod:`darsia_tpu.signals.models.thresholdmodel`.
"""

from __future__ import annotations

from .dynamicthresholdmodel import DynamicThresholdModel
from .staticthresholdmodel import StaticThresholdModel

__all__ = ["ThresholdModel"]


class ThresholdModel:
    """Manager of the thresholding models.

    Options (with ``key`` prefix): ``threshold dynamic`` (bool),
    ``threshold value`` (float or per-label list), ``threshold method``,
    ``threshold value min`` / ``threshold value max``.
    """

    def __init__(self, labels=None, key: str = "", **kwargs) -> None:
        if kwargs.get(key + "threshold dynamic", False):
            method = kwargs.get(key + "threshold method", "otsu")
            # The JAX package's mapping of method names, in its order: a name
            # with "min" or "two" is two-peak ("tailored global min" too).
            if "min" in method or "two" in method:
                method = "two-peak"
            elif "otsu" in method or "tailored" in method:
                method = "otsu"
            self.model = DynamicThresholdModel(
                method=method,
                threshold_min=kwargs.get(key + "threshold value min", 0.0),
                threshold_max=kwargs.get(key + "threshold value max", 1.0),
                labels=labels,
                key=key,
                **{k: v for k, v in kwargs.items() if "threshold" not in k},
            )
        else:
            self.model = StaticThresholdModel(
                threshold_lower=kwargs.get(key + "threshold value", 0.0),
                labels=labels,
            )

    def __call__(self, img, mask=None):
        return self.model(img, mask)

    def update_model_parameters(self, parameters, dofs=None) -> None:
        self.model.update_model_parameters(parameters, dofs)
