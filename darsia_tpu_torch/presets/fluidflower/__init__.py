"""FluidFlower presets: the CO2 and tracer analyses and the rig."""

from .benchmarkco2model import (
    benchmark_binary_cleaning_preset,
    benchmark_concentration_analysis_preset,
)
from .fluidflowerco2analysis import FluidFlowerCO2Analysis
from .fluidflowerrig import FluidFlowerRig
from .fluidflowertraceranalysis import (
    FluidFlowerTracerAnalysis,
    TailoredConcentrationAnalysis,
)

__all__ = [
    "FluidFlowerCO2Analysis",
    "FluidFlowerRig",
    "FluidFlowerTracerAnalysis",
    "TailoredConcentrationAnalysis",
    "benchmark_binary_cleaning_preset",
    "benchmark_concentration_analysis_preset",
]
