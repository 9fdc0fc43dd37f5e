"""Analysis presets (counterpart of :mod:`darsia_tpu.presets.analysis`)."""

from .multichromatictracer import MultichromaticTracerAnalysis
from .porosity import PorosityAnalysis, patched_porosity_analysis

__all__ = ["MultichromaticTracerAnalysis", "PorosityAnalysis", "patched_porosity_analysis"]
