"""Signal reductions."""

from .dimensionreduction import AxisReduction, extrude_along_axis, reduce_axis
from .signalreduction import MonochromaticReduction, SignalReduction

__all__ = [
    "AxisReduction",
    "MonochromaticReduction",
    "SignalReduction",
    "extrude_along_axis",
    "reduce_axis",
]
