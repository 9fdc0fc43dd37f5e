"""Workflow utilities (counterpart of :mod:`darsia_tpu.presets.workflows.utils`;
ported: the mass-map loader of the comparison workflow)."""

from .mass import load_data

__all__ = ["load_data"]
