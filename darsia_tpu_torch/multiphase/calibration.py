"""Calibration of multiphase transformations against expected masses.

Counterpart of :mod:`darsia_tpu.multiphase.calibration`: a propose ->
preview -> accept stepper (:class:`TransformationCalibrationSession`) over
the port's ``MultiphaseTimeSeriesAnalysis`` and ``PWTransformation``.  The
expensive pre-mass analysis runs once per photograph and is kept (on its
device); every proposal re-runs only the mass-analysis tail.  ``auto()``
wraps the loop in scipy's Nelder-Mead on the host.
``calibrate_transformations`` is the functional entry point.  ``preview``
draws its plot with matplotlib where it imports; where it does not, a
preview with a path raises and names matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..utils.optional import optional_module

__all__ = ["TransformationCalibrationSession", "calibrate_transformations"]


class TransformationCalibrationSession:
    """Propose -> preview -> accept calibration stepper.

    Args:
        transformation_g / transformation_aq: gas/aqueous
            PWTransformations to calibrate (updated in place).
        paths: image paths of the calibration series.
        multiphase_time_series_analysis: tracker (reset per proposal).
        upper_time_limit: split between "early" and "late" errors (hours).
        read_image / pre_mass_analysis / mass_analysis_from_pre: the three
            callables of the calibration routine (read, pre-mass, mass tail).
        expected_mass: callable time -> expected (injected) mass; defaults
            to the tracker's own exact-mass column if absent.
        log: folder receiving the iteration log on accept().
    """

    def __init__(
        self,
        transformation_g,
        transformation_aq,
        paths: list,
        multiphase_time_series_analysis,
        upper_time_limit: float,
        read_image: Callable,
        pre_mass_analysis: Callable,
        mass_analysis_from_pre: Callable,
        expected_mass: Optional[Callable] = None,
        log: Optional[Path] = None,
        clean_threshold: float = 1.0,
        verbose: bool = False,
    ) -> None:
        self.transformation_g = transformation_g
        self.transformation_aq = transformation_aq
        self.paths = [Path(p) for p in paths]
        self.analysis = multiphase_time_series_analysis
        self.upper_time_limit = float(upper_time_limit)
        self.mass_analysis_from_pre = mass_analysis_from_pre
        self.expected_mass = expected_mass
        self.log = Path(log) if log is not None else None
        self.clean_threshold = clean_threshold
        self.verbose = verbose
        self.iterations: list[dict] = []
        self.accepted = False

        # The pre-mass analysis, computed once.
        self.pre_mass_results: dict = {}
        for i, path in enumerate(self.paths):
            img = read_image(path)
            self.pre_mass_results[path] = pre_mass_analysis(img)
            if verbose:
                print(
                    f"Pre-mass analysis for {path.name} done. "
                    f"{i + 1}/{len(self.paths)}"
                )

    # ----------------------------------------------------------- evaluation

    def _evaluate(self) -> dict:
        """Re-run the mass-analysis tail with the current transformations."""
        self.analysis.reset()
        for path in self.paths:
            result = self.mass_analysis_from_pre(self.pre_mass_results[path])
            self.analysis.track(result)
        self.analysis.clean(threshold=self.clean_threshold)

        data = self.analysis.data
        run_time = np.asarray(data.times, dtype=float)
        detected = np.asarray(data.mass, dtype=float)
        detected_g = np.asarray(data.mass_g, dtype=float)
        detected_aq = np.asarray(data.mass_aq, dtype=float)
        if self.expected_mass is not None:
            expected = np.asarray([self.expected_mass(t) for t in run_time])
        elif hasattr(data, "exact_mass"):
            expected = np.asarray(data.exact_mass, dtype=float)
        else:
            expected = np.zeros_like(detected)

        early = run_time < self.upper_time_limit
        square_error = np.square(detected - expected)
        return {
            "time": run_time,
            "detected_mass": detected,
            "detected_mass_g": detected_g,
            "detected_mass_aq": detected_aq,
            "expected_mass": expected,
            "error": float(square_error.sum()),
            "early_error": float(square_error[early].sum()),
            "late_error": float(square_error[~early].sum()),
        }

    # -------------------------------------------------------------- stepper

    def propose(self, values_g=None, values_aq=None) -> dict:
        """Set transformation values (the slider move) and evaluate."""
        if values_g is not None:
            self.transformation_g.update(values=np.asarray(values_g, float))
        if values_aq is not None:
            self.transformation_aq.update(values=np.asarray(values_aq, float))
        metrics = self._evaluate()
        self.iterations.append(
            {
                "iteration": len(self.iterations),
                "values_g": np.array(self.transformation_g.values, copy=True),
                "values_aq": np.array(self.transformation_aq.values, copy=True),
                "error": metrics["error"],
                "early_error": metrics["early_error"],
                "late_error": metrics["late_error"],
            }
        )
        if self.verbose:
            print(
                f"iteration {len(self.iterations) - 1}: "
                f"error {metrics['error']:.4e} "
                f"(early {metrics['early_error']:.4e}, "
                f"late {metrics['late_error']:.4e})"
            )
        return metrics

    def preview(self, path: Optional[Path] = None) -> dict:
        """Current state; optionally write the mass-over-time plot."""
        metrics = self._evaluate()
        if path is not None:
            optional_module("matplotlib", "TransformationCalibrationSession.preview(path=...)").use("Agg")
            plt = optional_module("matplotlib.pyplot", "TransformationCalibrationSession.preview(path=...)")

            fig, ax = plt.subplots()
            ax.plot(metrics["time"], metrics["detected_mass"], label="detected")
            ax.plot(
                metrics["time"], metrics["detected_mass_g"], label="gaseous"
            )
            ax.plot(
                metrics["time"], metrics["detected_mass_aq"], label="aqueous"
            )
            ax.plot(
                metrics["time"],
                metrics["expected_mass"],
                "k--",
                label="expected",
            )
            ax.axvline(self.upper_time_limit, color="gray", linestyle=":")
            ax.set_xlabel("time [h]")
            ax.set_ylabel("mass [kg]")
            ax.legend()
            fig.savefig(Path(path))
            plt.close(fig)
        return metrics

    def accept(self) -> tuple:
        """Finalize: persist the iteration log, return the transformations."""
        self.accepted = True
        if self.log is not None:
            self.log.mkdir(parents=True, exist_ok=True)
            np.savez(
                self.log / "calibration_log.npz",
                error=np.asarray([it["error"] for it in self.iterations]),
                early_error=np.asarray(
                    [it["early_error"] for it in self.iterations]
                ),
                late_error=np.asarray(
                    [it["late_error"] for it in self.iterations]
                ),
                values_g=np.asarray([it["values_g"] for it in self.iterations]),
                values_aq=np.asarray(
                    [it["values_aq"] for it in self.iterations]
                ),
                supports_g=np.asarray(self.transformation_g.supports),
                supports_aq=np.asarray(self.transformation_aq.supports),
            )
        return self.transformation_g, self.transformation_aq

    # ------------------------------------------------------------ automatic

    def auto(
        self,
        maxiter: int = 100,
        calibrate: str = "both",
        weight_early: float = 1.0,
        weight_late: float = 1.0,
    ) -> dict:
        """Nelder-Mead over the transformation values (the machine on the
        sliders).  Monotonicity is enforced by optimizing increments."""
        from scipy.optimize import minimize

        g0 = np.asarray(self.transformation_g.values, float)
        aq0 = np.asarray(self.transformation_aq.values, float)
        use_g = calibrate in ("both", "g", "gas")
        use_aq = calibrate in ("both", "aq", "aqueous")

        # Optimize the increments between nodes (first value stays anchored
        # — it is the zero-signal response); nonnegativity of increments
        # keeps the transformation monotone.
        def from_increments(v0, inc):
            return v0 + np.concatenate([[0.0], np.cumsum(np.maximum(inc, 0.0))])

        x0 = np.concatenate(
            ([np.diff(g0)] if use_g else [])
            + ([np.diff(aq0)] if use_aq else [])
        )
        ng = len(g0) - 1 if use_g else 0

        def objective(x):
            values_g = from_increments(g0[0], x[:ng]) if use_g else None
            values_aq = from_increments(aq0[0], x[ng:]) if use_aq else None
            metrics = self.propose(values_g, values_aq)
            return (
                weight_early * metrics["early_error"]
                + weight_late * metrics["late_error"]
            )

        # A spread-out initial simplex lets Nelder-Mead escape the default
        # 5%-perturbation basin (slider moves are coarse too).
        n = len(x0)
        simplex = [x0]
        for i in range(n):
            vertex = x0.copy()
            vertex[i] = vertex[i] * 2.0 if vertex[i] != 0 else 0.5
            simplex.append(vertex)
        result = minimize(
            objective,
            x0,
            method="Nelder-Mead",
            options={
                "maxiter": maxiter,
                "initial_simplex": np.asarray(simplex),
                "xatol": 1e-6,
                "fatol": 1e-12,
            },
        )
        # Apply the optimum.
        values_g = from_increments(g0[0], result.x[:ng]) if use_g else None
        values_aq = from_increments(aq0[0], result.x[ng:]) if use_aq else None
        metrics = self.propose(values_g, values_aq)
        metrics["optimizer_success"] = bool(result.success)
        metrics["optimizer_iterations"] = int(result.nit)
        return metrics


def calibrate_transformations(
    transformation_g,
    transformation_aq,
    paths: list,
    multiphase_time_series_analysis,
    upper_time_limit: float,
    read_image: Callable,
    pre_mass_analysis: Callable,
    mass_analysis_from_pre: Callable,
    log: Path,
    expected_mass: Optional[Callable] = None,
    maxiter: int = 100,
) -> None:
    """Functional entry point: runs the automatic stepper (in place of a
    slider UI) and persists the log."""
    session = TransformationCalibrationSession(
        transformation_g,
        transformation_aq,
        paths,
        multiphase_time_series_analysis,
        upper_time_limit,
        read_image,
        pre_mass_analysis,
        mass_analysis_from_pre,
        expected_mass=expected_mass,
        log=log,
    )
    session.auto(maxiter=maxiter)
    session.accept()
