"""Signal reductions."""

from .signalreduction import MonochromaticReduction, SignalReduction

__all__ = ["MonochromaticReduction", "SignalReduction"]
