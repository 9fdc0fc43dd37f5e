"""Multiphase analysis: flash, CO2 mass, time series."""

from .calibration import TransformationCalibrationSession, calibrate_transformations
from .flash import AdvancedFlash, Flash, SimpleFlash
from .fluidflower_co2_meta import FluidFlowerCO2Meta
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
    "FluidFlowerCO2Meta",
    "MassAnalysisResults",
    "MultiphaseTimeSeriesAnalysis",
    "MultiphaseTimeSeriesData",
    "SimpleFlash",
    "SimpleMassAnalysisResults",
    "ThresholdAnalysisResults",
    "TimeSeriesData",
    "TransformationCalibrationSession",
    "calibrate_transformations",
    "co2_gas_density",
    "co2_solubility",
    "full_like",
    "water_density",
]
