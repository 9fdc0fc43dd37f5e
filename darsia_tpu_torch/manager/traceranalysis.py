"""Tracer analysis manager.

Counterpart of :mod:`darsia_tpu.manager.traceranalysis`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Union

from ..analysis.concentrationanalysis import ConcentrationAnalysis
from ..measure.integration import Geometry
from .concentrationanalysisbase import ConcentrationAnalysisBase

__all__ = ["TracerAnalysis"]


class TracerAnalysis(ABC, ConcentrationAnalysisBase):
    """Abstract tracer analysis: subclasses define the tracer analysis."""

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        update_setup: bool = False,
        device=None,
    ) -> None:
        super().__init__(baseline, config, update_setup, device)
        if "tracer" not in self.config:
            raise ValueError("Tracer analysis not well defined.")
        self.tracer_analysis = self.define_tracer_analysis()
        if not isinstance(self.tracer_analysis, ConcentrationAnalysis):
            raise ValueError("tracer_analysis has wrong type.")
        tracer_config = self.config.get("tracer", {})
        cleaning_filter = tracer_config.get("cleaning_filter", "cache/cleaning_filter_tracer.npy")
        self._setup_concentration_analysis(
            self.tracer_analysis, cleaning_filter, baseline, update_setup
        )

    @abstractmethod
    def define_tracer_analysis(self) -> ConcentrationAnalysis:
        """Define the tracer concentration analysis (problem specific)."""

    def determine_tracer(self, return_volume: bool = False):
        """Tracer concentration of the currently loaded image (and its
        integral, summed on the image's device)."""
        concentration = self.tracer_analysis(self.img)
        if return_volume:
            geometry = Geometry(**concentration.shape_metadata())
            return concentration, float(geometry.integrate(concentration))
        return concentration

    def single_image_analysis(self, img, **kwargs):
        """Load an image and determine its tracer concentration."""
        self.load_and_process_image(img)
        return self.determine_tracer(**kwargs)
