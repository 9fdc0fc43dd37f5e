"""Mass computation: signal transformation, flash and mass analysis, with a
fit of the transformation to the injected mass.

Counterpart of :mod:`darsia_tpu.presets.workflows.mass_computation` (the fit
is scipy's Powell search over monotone increments, as there).
"""

from __future__ import annotations

import logging

import numpy as np

from ...signals.models.pwtransformation import PWTransformation
from ...utils.optional import optional_module
from .simple_run_analysis import SimpleRunAnalysis

logger = logging.getLogger(__name__)

__all__ = ["MassComputation"]


class MassComputation:
    """Transform a scalar signal into CO2 mass via flash and mass analysis."""

    def __init__(self, baseline, geometry, flash, co2_mass_analysis) -> None:
        self.baseline = baseline
        self.geometry = geometry
        self.flash = flash
        self.co2_mass_analysis = co2_mass_analysis
        self.transformation = PWTransformation(
            supports=[-1, 0, 0.1, 0.25] + np.linspace(0.5, 1.0, 11).tolist() + [10.0],
            values=[0, 0, 0.1, 0.25] + np.linspace(0.5, 2, 11).tolist() + [2],
        )

    def __call__(self, signal):
        """Signal image -> MassAnalysisResults."""
        transformed = self.transformation(signal)
        c_aq, s_g = self.flash(transformed)
        return self.co2_mass_analysis.mass_analysis(c_aq=c_aq, s_g=s_g)

    def integrated_mass(self, signal) -> float:
        return float(self.geometry.integrate(self(signal).mass))

    def fit(self, untransformed_images: list, experiment, maxiter: int = 200) -> None:
        """Fit the transformation's values to the injected mass at the image
        dates (Powell over monotone increments)."""
        from scipy.optimize import minimize

        expected = [
            float(experiment.injection_protocol.injected_mass(date=img.date))
            for img in untransformed_images
        ]
        values0 = np.asarray(self.transformation.values, dtype=float)
        diffs0 = np.diff(values0)

        def install(diffs):
            values = np.concatenate([[values0[0]], np.abs(diffs)]).cumsum()
            self.transformation.update(values=values)

        def objective(diffs):
            install(diffs)
            error = 0.0
            for img, mass_expected in zip(untransformed_images, expected):
                error += (self.integrated_mass(img) - mass_expected) ** 2
            return error

        result = minimize(
            objective, diffs0, method="Powell", options={"maxiter": maxiter, "ftol": 1e-12}
        )
        install(result.x)
        logger.info("MassComputation fit finished: %s", result.message)

    def track(self, images: list) -> SimpleRunAnalysis:
        """Run the analysis over a series and return the tracker."""
        analysis = SimpleRunAnalysis(self.geometry)
        for img in images:
            analysis.append(self(img), name=getattr(img, "name", ""))
        return analysis

    def compute_total_mass(self, img) -> float:
        """Total mass of a signal image."""
        return self.integrated_mass(img)

    def calibration(self, calibration_data: dict) -> None:
        """Per-label linear rescaling from target and current means."""
        if not hasattr(self, "transformations"):
            self.transformations: dict = {}
        for label, data in calibration_data.items():
            target_mean = data["target_mean"]
            current_mean = data["current_mean"]
            scale = target_mean / current_mean if current_mean != 0 else 1.0
            self.transformations[label] = lambda x, s=scale: x * s

    def load(self, path) -> None:
        self.transformation = PWTransformation.load(path)

    def save(self, path) -> None:
        self.transformation.save(path)

    def show(self) -> None:
        """Plot the signal-to-mass transformation's nodes."""
        plt = optional_module("matplotlib.pyplot", "MassComputation.show")

        supports = np.asarray(self.transformation.supports)
        values = np.asarray(self.transformation.values)
        plt.figure("MassComputation transformation")
        plt.plot(supports, values, "o-")
        plt.xlabel("signal")
        plt.ylabel("transformed signal")
        plt.show()
