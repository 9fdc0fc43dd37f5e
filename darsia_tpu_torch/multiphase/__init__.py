"""Multiphase analysis: flash, CO2 mass, time series."""

from .flash import AdvancedFlash, Flash, SimpleFlash
from .mass_analysis import (
    EPSILON,
    AdvancedCO2MassAnalysis,
    CO2MassAnalysis,
    MassAnalysisResults,
    SimpleMassAnalysisResults,
    ThresholdAnalysisResults,
    co2_gas_density,
    co2_solubility,
    full_like,
    water_density,
)
from .time_series import MultiphaseTimeSeriesAnalysis, MultiphaseTimeSeriesData, TimeSeriesData

__all__ = [
    "EPSILON",
    "AdvancedCO2MassAnalysis",
    "AdvancedFlash",
    "CO2MassAnalysis",
    "Flash",
    "MassAnalysisResults",
    "MultiphaseTimeSeriesAnalysis",
    "MultiphaseTimeSeriesData",
    "SimpleFlash",
    "SimpleMassAnalysisResults",
    "ThresholdAnalysisResults",
    "TimeSeriesData",
    "co2_gas_density",
    "co2_solubility",
    "full_like",
    "water_density",
]
