"""Comparison workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.comparison`)."""

from .comparison_events import comparison_events
from .comparison_wasserstein import WassersteinDistanceResult, comparison_wasserstein

__all__ = ["WassersteinDistanceResult", "comparison_events", "comparison_wasserstein"]
