"""CO2 (two-component) analysis manager.

Counterpart of :mod:`darsia_tpu.manager.co2analysis`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Union
from warnings import warn

from ..analysis.concentrationanalysis import ConcentrationAnalysis
from .concentrationanalysisbase import ConcentrationAnalysisBase

__all__ = ["CO2Analysis"]


class CO2Analysis(ABC, ConcentrationAnalysisBase):
    """Dual analysis of CO2 (total) and CO2(g) in a time series."""

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        update_setup: bool = False,
        device=None,
    ) -> None:
        super().__init__(baseline, config, update_setup, device)

        if "co2" in self.config:
            self.co2_analysis = self.define_co2_analysis()
            if not isinstance(self.co2_analysis, ConcentrationAnalysis):
                raise ValueError("co2_analysis has wrong type.")
            self._setup_concentration_analysis(
                self.co2_analysis,
                self.config["co2"].get("cleaning_filter", "cache/cleaning_filter_co2.npy"),
                baseline,
                update_setup,
            )
        else:
            warn("CO2 analysis not well-defined.")

        if "co2(g)" in self.config:
            self.co2_gas_analysis = self.define_co2_gas_analysis()
            if not isinstance(self.co2_gas_analysis, ConcentrationAnalysis):
                raise ValueError("co2_gas_analysis has wrong type.")
            self._setup_concentration_analysis(
                self.co2_gas_analysis,
                self.config["co2(g)"].get(
                    "cleaning_filter", "cache/cleaning_filter_co2_gas.npy"
                ),
                baseline,
                update_setup,
            )
        else:
            warn("CO2(g) analysis not well-defined.")

    @abstractmethod
    def define_co2_analysis(self) -> ConcentrationAnalysis:
        """Define the total-CO2 concentration analysis."""

    @abstractmethod
    def define_co2_gas_analysis(self) -> ConcentrationAnalysis:
        """Define the gaseous-CO2 concentration analysis."""

    def determine_co2(self):
        """CO2 map of the currently loaded image."""
        return self.co2_analysis(self.img)

    def determine_co2_gas(self):
        """CO2(g) map of the currently loaded image."""
        return self.co2_gas_analysis(self.img)

    def single_image_analysis(self, img, **kwargs):
        """Load an image and return its (co2, co2_gas) maps."""
        self.load_and_process_image(img)
        return self.determine_co2(), self.determine_co2_gas()
