"""Experiment protocols: imaging, injection and pressure/temperature tables,
and the experiment that finds its images by time.

Counterpart of :mod:`darsia_tpu.experiment`; host-side Python (no pandas).
"""

from .events import find_images_for_datetimes
from .experiment import Experiment, ProtocolledExperiment, TimeWindow
from .protocols import (
    ImagingInterval,
    ImagingProtocol,
    ImagingProtocolOld,
    InjectionProtocol,
    PressureTemperatureProtocol,
    ProtocolTable,
    ThermodynamicState,
)

__all__ = [
    "Experiment",
    "ImagingInterval",
    "ImagingProtocol",
    "ImagingProtocolOld",
    "InjectionProtocol",
    "PressureTemperatureProtocol",
    "ProtocolTable",
    "ProtocolledExperiment",
    "ThermodynamicState",
    "TimeWindow",
    "find_images_for_datetimes",
]
