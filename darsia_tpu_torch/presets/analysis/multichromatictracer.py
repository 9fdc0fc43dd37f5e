"""Multichromatic tracer analysis: kernel-interpolated concentration on
labelled media.

Counterpart of :mod:`darsia_tpu.presets.analysis.multichromatictracer`.  The
per-label kernel models run on the image's device
(:class:`~darsia_tpu_torch.signals.models.basemodel.HeterogeneousModel` of
:class:`~darsia_tpu_torch.signals.models.kernelinterpolation.KernelInterpolation`);
the characteristic colours are clustered on the host, as in the JAX
package.  Calibration takes explicit sample boxes.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ...analysis.concentrationanalysis import ConcentrationAnalysis
from ...image.arithmetics import zeros_like
from ...signals.models.basemodel import HeterogeneousModel
from ...signals.models.combinedmodel import CombinedModel
from ...signals.models.kernelinterpolation import KernelInterpolation
from ...utils.extractcharacteristicdata import extract_characteristic_data
from ...utils.kernels import GaussianKernel
from ...utils.masks import Masks
from ...utils.npz import load_npz

logger = logging.getLogger(__name__)

__all__ = ["MultichromaticTracerAnalysis"]


class MultichromaticTracerAnalysis(ConcentrationAnalysis):
    """Concentration analysis with per-label kernel interpolation models."""

    def __init__(
        self,
        baseline,
        labels=None,
        relative: bool = True,
        show_plot: bool = False,
        **kwargs,
    ) -> None:
        restoration = kwargs.pop("restoration", None)
        config = kwargs.pop("config", {"diff option": "plain", "restoration -> model": False})
        if labels is None:
            labels = zeros_like(baseline, mode="voxels", dtype=np.uint8)
        self.relative = relative
        kernel = kwargs.pop("kernel", GaussianKernel(gamma=1))
        kwargs.pop("use_tvd", None)
        model = CombinedModel([HeterogeneousModel(KernelInterpolation(kernel), labels)])
        self.characteristic_colors: list = []
        self.concentrations: list = []
        super().__init__(
            base=baseline if relative else None,
            restoration=restoration,
            labels=labels,
            model=model,
            **config,
        )
        self.show_plot = show_plot

    # ------------------------------------------------------------------ call

    def expert_knowledge(self, image) -> None:
        """Hook for posterior constraints (no-op by default)."""

    def __call__(self, image):
        concentration = super().__call__(image)
        self.expert_knowledge(concentration)
        return concentration

    # ------------------------------------------------------------------- io

    def save(self, path: Path) -> None:
        np.savez(
            path,
            config={
                "characteristic_colors": self.characteristic_colors,
                "concentrations": self.concentrations,
                "info": "MultichromaticTracerAnalysis calibration data.",
            },
        )
        logger.info("Calibration data saved to %s.", path)

    def load(self, path: Path) -> None:
        data = load_npz(path, ("config",))["config"].item()
        self.characteristic_colors = data["characteristic_colors"]
        self.concentrations = data["concentrations"]
        self.calibrate(self.characteristic_colors, self.concentrations)

    # ------------------------------------------------------------ calibrate

    def calibrate(self, colors, concentrations) -> None:
        """Install per-label support points into the kernel models."""
        for i, (_, label) in enumerate(Masks(self.labels, return_label=True)):
            self.model[0][label].update(
                supports=np.asarray(colors[i]), values=np.asarray(concentrations[i])
            )

    def calibrate_from_samples(
        self,
        calibration_image,
        samples_per_label: list,
        concentrations_per_label: list,
        num_clusters: int = 5,
        reset: bool = False,
    ) -> None:
        """Calibrate from explicit sample boxes + concentration values.

        Args:
            calibration_image: image to extract characteristic colours from.
            samples_per_label: per label, a list of 2-D slice tuples.
            concentrations_per_label: per label, concentration per sample.
            num_clusters: clusters per sample for colour extraction.
            reset: start calibration from scratch.
        """
        model_cache, restoration_cache = self.model, self.restoration
        self.model = None
        self.restoration = None
        try:
            if reset:
                self.characteristic_colors = []
                self.concentrations = []
            pre_concentration = ConcentrationAnalysis.__call__(self, calibration_image)
            pre_base = ConcentrationAnalysis.__call__(self, self.base) if self.relative else None
            for i, mask in enumerate(Masks(self.labels)):
                samples = samples_per_label[i]
                concentrations = list(concentrations_per_label[i])
                characteristic_colors = extract_characteristic_data(
                    signal=pre_concentration.img,
                    mask=mask.img,
                    samples=samples,
                    num_clusters=num_clusters,
                    show_plot=self.show_plot,
                )
                if self.relative:
                    base_colors = extract_characteristic_data(
                        signal=pre_base.img,
                        mask=mask.img,
                        samples=samples,
                        num_clusters=num_clusters,
                        show_plot=self.show_plot,
                    )
                    characteristic_colors = np.vstack(
                        (np.zeros((1, 3)), base_colors, characteristic_colors)
                    )
                    concentrations = np.array([0] + [0] * len(samples) + concentrations)
                if len(self.characteristic_colors) > i:
                    self.characteristic_colors[i] = np.vstack(
                        (characteristic_colors, self.characteristic_colors[i])
                    )
                    self.concentrations[i] = np.hstack((concentrations, self.concentrations[i]))
                else:
                    self.characteristic_colors.append(characteristic_colors)
                    self.concentrations.append(np.asarray(concentrations))
        finally:
            self.model, self.restoration = model_cache, restoration_cache
        self.calibrate(self.characteristic_colors, self.concentrations)

    # Alias kept for reference-API familiarity (non-interactive here).
    calibrate_from_image = calibrate_from_samples

