"""FluidFlower presets: the CO2 and tracer analyses, the rig and the simple rig."""

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
from .simplefluidflower import SimpleFluidFlower

__all__ = [
    "FluidFlowerCO2Analysis",
    "FluidFlowerRig",
    "FluidFlowerTracerAnalysis",
    "SimpleFluidFlower",
    "TailoredConcentrationAnalysis",
    "benchmark_binary_cleaning_preset",
    "benchmark_concentration_analysis_preset",
]
