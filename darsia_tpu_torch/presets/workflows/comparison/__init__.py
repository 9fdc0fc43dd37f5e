"""Comparison workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.comparison`; ``comparison_events`` is not
ported: it needs the config layer, ROADMAP.md Queue 1 item 7)."""

from .comparison_wasserstein import WassersteinDistanceResult, comparison_wasserstein

__all__ = ["WassersteinDistanceResult", "comparison_wasserstein"]
