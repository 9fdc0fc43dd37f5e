"""Concentration-analysis manager base.

Counterpart of :mod:`darsia_tpu.manager.concentrationanalysisbase`: the
cleaning filter is read from its ``.npy`` cache or learnt from the baselines
and written there; both packages read and write the same files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..analysis.concentrationanalysis import ConcentrationAnalysis
from .analysisbase import AnalysisBase

__all__ = ["ConcentrationAnalysisBase"]


class ConcentrationAnalysisBase(AnalysisBase):
    """AnalysisBase + the cleaning filters of its concentration analyses."""

    def _setup_concentration_analysis(
        self,
        concentration_analysis: ConcentrationAnalysis,
        cleaning_filter: Union[str, Path],
        baseline_images,
        update: bool = False,
    ) -> None:
        """Read a cached cleaning filter, or learn it from the baselines (read
        through the chain once, shared by all analyses) and cache it."""
        cleaning_filter = Path(cleaning_filter)
        if not update and cleaning_filter.exists():
            concentration_analysis.read_cleaning_filter_from_file(cleaning_filter)
        else:
            if not isinstance(baseline_images, list):
                baseline_images = [baseline_images]
            if self.processed_baseline_images is None:
                self.processed_baseline_images = [self._read(path) for path in baseline_images]
            concentration_analysis.find_cleaning_filter(self.processed_baseline_images)
            cleaning_filter.parent.mkdir(parents=True, exist_ok=True)
            concentration_analysis.write_cleaning_filter_to_file(cleaning_filter)
