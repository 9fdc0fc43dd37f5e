"""Model calibration mixins for ConcentrationAnalysis.

Counterpart of :mod:`darsia_tpu.analysis.model_calibration`: the line fits
(least squares, and a seeded RANSAC-style loop) run on the host, and
``scipy.optimize.minimize`` drives the objective as there.  Each evaluation
converts the calibration images and integrates them with the geometry on
their device, one host read per image.
"""

from __future__ import annotations

import abc
from typing import Union

import numpy as np

from ..utils.optional import optional_module

__all__ = [
    "AbstractModelObjective",
    "InjectionRateModelObjectiveMixin",
    "AbsoluteVolumeModelObjectiveMixin",
]


def _linear_fit(times: np.ndarray, values: np.ndarray) -> tuple[float, float]:
    """Least-squares line fit: returns (slope, intercept)."""
    A = np.stack([times, np.ones_like(times)], axis=1)
    sol, *_ = np.linalg.lstsq(A, values, rcond=None)
    return float(sol[0]), float(sol[1])


def _ransac_fit(
    times: np.ndarray, values: np.ndarray, num_trials: int = 50, seed: int = 0
) -> tuple[float, float]:
    """RANSAC-style robust line fit (self-contained)."""
    n = len(times)
    if n <= 2:
        return _linear_fit(times, values)
    rng = np.random.default_rng(seed)
    residual_scale = max(np.std(values), 1e-12)
    best_inliers = None
    for _ in range(num_trials):
        idx = rng.choice(n, size=2, replace=False)
        t2, v2 = times[idx], values[idx]
        if abs(t2[1] - t2[0]) < 1e-15:
            continue
        slope = (v2[1] - v2[0]) / (t2[1] - t2[0])
        intercept = v2[0] - slope * t2[0]
        residuals = np.abs(values - (slope * times + intercept))
        inliers = residuals < 0.3 * residual_scale
        if best_inliers is None or inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    if best_inliers is None or best_inliers.sum() < 2:
        return _linear_fit(times, values)
    return _linear_fit(times[best_inliers], values[best_inliers])


class AbstractModelObjective:
    """Calibration harness mixin: combine with ConcentrationAnalysis."""

    @abc.abstractmethod
    def define_objective_function(
        self, input_images, images_diff, times, options: dict
    ):
        ...

    def update_model_for_calibration(self, parameters, options: dict) -> None:
        dofs = options.get("dofs", None)
        self.model.update_model_parameters(parameters, dofs)

    def calibrate_model(
        self, images, options: dict, plot_result: bool = False
    ) -> bool:
        """Calibrate the conversion model against physical constraints.

        Args:
            images: calibration image list (or a series image).
            options: "initial_guess" (required), "tol", "maxiter", "method",
                plus objective-specific entries.

        """
        from scipy import optimize

        if not isinstance(images, list):
            assert images.series
            series = images.copy()
            images = [series.time_slice(i) for i in range(series.time_num)]

        images_diff = [self._subtract_background(img) for img in images]
        images_signal = [self._reduce_signal(d) for d in images_diff]
        images_clean = [self._clean_signal(s) for s in images_signal]
        images_balanced = [self._balance_signal(s) for s in images_clean]
        assert self.first_restoration_then_model, (
            "calibration only implemented for restoration -> model ordering"
        )
        images_smooth = [self._restore_signal(s) for s in images_balanced]

        times = [img.time for img in images]
        if any(t is None for t in times):
            raise ValueError("Provide images with well-defined reference time.")

        objective = self.define_objective_function(
            images_smooth, images_diff, times, options
        )
        result = optimize.minimize(
            objective,
            options["initial_guess"],
            tol=options.get("tol"),
            options={"maxiter": options.get("maxiter"), "disp": False},
            method=options.get("method"),
        )
        self.update_model_for_calibration(result.x, options)
        if plot_result:
            self._visualize_model_calibration(
                images_smooth, images_diff, times, options
            )
        return bool(result.success)

    def _visualize_model_calibration(self, input_images, images_diff, times, options) -> None:
        plt = optional_module("matplotlib.pyplot", "plotting the model calibration")

        geometry = options["geometry"]
        volumes = [
            float(geometry.integrate(self._convert_signal(img, diff)))
            for img, diff in zip(input_images, images_diff)
        ]
        plt.plot(times, volumes, "o-")
        plt.xlabel("time")
        plt.ylabel("integrated volume")
        plt.show()


class InjectionRateModelObjectiveMixin(AbstractModelObjective):
    """Objective: match a constant injection rate (slope of volume(t))."""

    def define_objective_function(
        self, input_images, images_diff, times, options: dict
    ):
        injection_rate = options["injection_rate"]
        geometry = options["geometry"]
        regression_type = options.get("regression_type", "ransac").lower()
        assert regression_type in ("ransac", "linear")
        times_arr = np.asarray(times, dtype=float)

        def objective_function(params: np.ndarray) -> float:
            self.update_model_for_calibration(params, options)
            volumes = np.array(
                [
                    float(geometry.integrate(self._convert_signal(img, diff)))
                    for img, diff in zip(input_images, images_diff)
                ]
            )
            if regression_type == "ransac":
                slope, intercept = _ransac_fit(times_arr, volumes)
            else:
                slope, intercept = _linear_fit(times_arr, volumes)
            self._slope = slope
            self._reference_slope = injection_rate
            self._intercept = intercept
            defect = slope - injection_rate
            if abs(injection_rate) > 1e-15:
                defect /= injection_rate
            return defect**2

        return objective_function

    def model_calibration_postanalysis(self) -> float:
        """Relative injection-rate defect of the last calibration."""
        return abs(self._slope - self._reference_slope) / abs(
            self._reference_slope
        )


class AbsoluteVolumeModelObjectiveMixin(AbstractModelObjective):
    """Objective: match a measured volume-over-time curve in L2."""

    def define_objective_function(
        self, input_images, images_diff, times, options: dict
    ):
        from scipy import interpolate

        geometry = options["geometry"]
        input_times = np.asarray(options["times"], dtype=float)
        input_volumes = np.asarray(options["volumes"], dtype=float)
        input_data = interpolate.interp1d(input_times, input_volumes)

        time_interval = np.asarray(options["time_interval"], dtype=float)
        total_time = float(time_interval.max() - time_interval.min())
        dt_min = float(np.min(np.diff(np.unique(input_times))))
        num_samples = int(total_time / dt_min)
        sampled_times = time_interval.min() + np.arange(num_samples) * dt_min
        sampled_input = input_data(sampled_times)

        def objective_function(params: np.ndarray) -> float:
            self.update_model_for_calibration(params, options)
            M3_TO_ML = 1e6
            volumes = [
                float(geometry.integrate(self._convert_signal(img, diff)))
                * M3_TO_ML
                for img, diff in zip(input_images, images_diff)
            ]
            estimated = interpolate.interp1d(times, volumes)
            sampled_estimated = estimated(sampled_times)
            defect = sampled_input - sampled_estimated
            return float(np.sum(defect**2) * dt_min)

        return objective_function
