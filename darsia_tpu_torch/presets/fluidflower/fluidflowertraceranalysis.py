"""FluidFlower tracer analysis preset.

Counterpart of :mod:`darsia_tpu.presets.fluidflower.fluidflowertraceranalysis`:
a per-label balancing (:class:`HeterogeneousLinearModel`), calibrated for
continuity across the labels' boundaries, and an injection-rate calibration
of the conversion model.

Two behaviours of the JAX package are mirrored (ROADMAP, reference faults 20
and 21): :meth:`FluidFlowerTracerAnalysis.calibrate_model` reads
``self.geometry``, which no class of the hierarchy sets (a subclass must);
and the preset's analysis converts before it restores, which the model
calibration refuses (it asserts the restoration -> model order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ...analysis.balancing_calibration import ContinuityBasedBalancingCalibrationMixin
from ...analysis.concentrationanalysis import ConcentrationAnalysis
from ...analysis.model_calibration import InjectionRateModelObjectiveMixin
from ...manager.traceranalysis import TracerAnalysis
from ...restoration.resize import Resize
from ...restoration.tvd import TVD
from ...signals.models.clipmodel import ClipModel
from ...signals.models.combinedmodel import CombinedModel
from ...signals.models.linearmodel import HeterogeneousLinearModel, LinearModel
from ...signals.reduction.signalreduction import MonochromaticReduction

__all__ = ["FluidFlowerTracerAnalysis", "TailoredConcentrationAnalysis"]


class TailoredConcentrationAnalysis(
    ConcentrationAnalysis,
    ContinuityBasedBalancingCalibrationMixin,
    InjectionRateModelObjectiveMixin,
):
    """Concentration analysis with balancing and injection-rate calibration."""


class FluidFlowerTracerAnalysis(TracerAnalysis):
    """Tracer analysis preset for FluidFlower rigs.

    A subclass may set ``self.labels`` before calling ``super().__init__``
    to balance per label; by default the whole image is one label.
    """

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        results: Union[str, Path],
        update_setup: bool = False,
        verbosity: int = 0,
        device=None,
    ) -> None:
        super().__init__(baseline, config, update_setup, device)
        if not hasattr(self, "labels"):
            self.labels = np.ones(tuple(self.base.img.shape[:2]), dtype=int)
        self.path_to_results = Path(results)
        self.path_to_results.parent.mkdir(parents=True, exist_ok=True)
        self.verbosity = verbosity

    def define_tracer_analysis(self) -> ConcentrationAnalysis:
        """Monochromatic reduction -> per-label balancing -> linear model and
        clip to [0, 1] -> resize, TVD, resize back."""
        options = self.config["tracer"]
        if not hasattr(self, "labels"):
            self.labels = np.ones(tuple(self.base.img.shape[:2]), dtype=int)
        signal_reduction = MonochromaticReduction(**options)
        balancing = HeterogeneousLinearModel(self.labels, key="balancing ", **options)
        original_shape = tuple(self.base.img.shape[:2])
        restoration = CombinedModel(
            [
                Resize(key="restoration ", **options),
                TVD(key="restoration ", **options),
                Resize(shape=original_shape),
            ]
        )
        model = CombinedModel(
            [
                LinearModel(key="model ", **options),
                ClipModel(min_value=0.0, max_value=1.0),
            ]
        )
        return TailoredConcentrationAnalysis(
            self.base,
            signal_reduction,
            balancing,
            restoration,
            model,
            self.labels,
            verbosity=options.get("verbosity", 0),
        )

    def calibrate_balancing(self, calibration_images: list, options: dict) -> None:
        images = [self._read(path) for path in calibration_images]
        self.tracer_analysis.calibrate_balancing(images, options)

    def calibrate_model(self, calibration_images: list, options: dict) -> None:
        images = [self._read(path) for path in calibration_images]
        self.tracer_analysis.calibrate_model(
            images,
            options=dict(options, **{"model_position": 0, "geometry": self.geometry}),
        )

    def single_image_analysis(self, img, **kwargs):
        """Tracer concentration of one photograph (a path or an Image)."""
        if hasattr(img, "img"):
            self.img = img.copy()
        else:
            self.load_and_process_image(img)
        return self.determine_tracer()
