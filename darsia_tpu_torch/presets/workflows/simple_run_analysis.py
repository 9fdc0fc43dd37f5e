"""Lightweight run analysis tracking integrated mass over a run.

Counterpart of :mod:`darsia_tpu.presets.workflows.simple_run_analysis`,
without its contour plots (they raise, naming matplotlib).
"""

from __future__ import annotations

from typing import Optional

from ...image.image import _absent
from ...multiphase.mass_analysis import MassAnalysisResults
from ...multiphase.time_series import MultiphaseTimeSeriesAnalysis, MultiphaseTimeSeriesData

__all__ = ["SimpleMultiphaseTimeSeriesData", "SimpleRunAnalysis"]

_PLOTS = (
    "plot_pure_contour_signal",
    "plot_simple_contour_signal",
    "plot_contour_saturation_concentration",
    "plot_contour_saturation",
    "plot_contour_concentration",
    "plot_dissolved_CO2",
    "plot_gas",
)


class SimpleRunAnalysis(MultiphaseTimeSeriesAnalysis):
    """Track the integrated mass over a run, optionally per ROI."""

    def __init__(self, geometry, colors: Optional[dict] = None) -> None:
        super().__init__(geometry)
        self.colors = colors or {}
        self.names: list = []

    def append(self, result: MassAnalysisResults, name: str = "") -> None:
        self.track(result)
        self.names.append(name or getattr(result, "name", ""))

    def integrated_mass(self, result: MassAnalysisResults, roi=None) -> dict:
        """Integrated total, gaseous and aqueous mass (of the ROI's
        subregion of the result when one is given)."""
        if roi is not None and hasattr(result, "subregion"):
            result = result.subregion(roi)
        return {
            "mass": float(self.geometry.integrate(result.mass)),
            "mass_g": float(self.geometry.integrate(result.mass_g)),
            "mass_aq": float(self.geometry.integrate(result.mass_aq)),
        }

    def reset(self) -> None:
        super().reset()
        self.names = []


def _plot(name: str):
    def plot(self, *args, **kwargs):
        raise _absent(f"SimpleRunAnalysis.{name}", "matplotlib")

    plot.__name__ = name
    return plot


for _name in _PLOTS:
    setattr(SimpleRunAnalysis, _name, _plot(_name))


class SimpleMultiphaseTimeSeriesData(MultiphaseTimeSeriesData):
    """Per-run time series with the image names attached."""

    def __init__(self) -> None:
        super().__init__()
        self.names: list = []

    def append(self, *args, name: str = "", **kwargs) -> None:
        super().append(*args, **kwargs)
        self.names.append(name)

    def reset(self) -> None:
        super().reset()
        self.names = []
