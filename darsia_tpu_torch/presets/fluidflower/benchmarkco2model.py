"""Benchmark CO2 concentration-analysis presets.

Counterpart of :mod:`darsia_tpu.presets.fluidflower.benchmarkco2model`.  The
binary clean-up (small objects, holes) runs on the host, as there; its mask
goes back to the baseline's device for the coarsened TVD smoothing.
"""

from __future__ import annotations

import numpy as np

from ...analysis.concentrationanalysis import PriorPosteriorConcentrationAnalysis
from ...restoration.binaryinpaint import BinaryFillHoles, BinaryRemoveSmallObjects
from ...restoration.resize import Resize
from ...restoration.tvd import TVD
from ...signals.models.binarydataselector import BinaryDataSelector
from ...signals.models.combinedmodel import CombinedModel
from ...signals.models.staticthresholdmodel import StaticThresholdModel
from ...signals.models.thresholdmodel import ThresholdModel
from ...signals.reduction.signalreduction import MonochromaticReduction

__all__ = [
    "benchmark_binary_cleaning_preset",
    "benchmark_concentration_analysis_preset",
]


def benchmark_binary_cleaning_preset(base, options: dict) -> CombinedModel:
    """Binary inpainting -> coarsened TVD smoothing -> threshold at 0.5."""
    original_shape = tuple(base.img.shape[:2])
    return CombinedModel(
        [
            BinaryRemoveSmallObjects(key="prior ", **options),
            BinaryFillHoles(key="prior ", **options),
            Resize(dtype=np.float32, key="prior ", device=base.device, **options),
            TVD(key="prior ", **options),
            Resize(shape=original_shape),
            StaticThresholdModel(0.5),
        ]
    )


def benchmark_concentration_analysis_preset(
    base, labels, options: dict
) -> PriorPosteriorConcentrationAnalysis:
    """Monochromatic reduction -> restoration -> thresholded prior -> the
    posterior review of its regions."""
    signal_reduction = MonochromaticReduction(**options)
    balancing = None
    original_shape = tuple(base.img.shape[:2])
    restoration = CombinedModel(
        [
            Resize(key="restoration ", **options),
            TVD(key="restoration ", **options),
            Resize(shape=original_shape),
        ]
    )
    prior_model = CombinedModel(
        [
            ThresholdModel(labels, key="prior ", **options),
            benchmark_binary_cleaning_preset(base, options),
        ]
    )
    posterior_model = BinaryDataSelector(key="posterior ", **options)
    return PriorPosteriorConcentrationAnalysis(
        base,
        signal_reduction,
        balancing,
        restoration,
        prior_model,
        posterior_model,
        labels,
        **options,
    )
