"""Colour -> pH -> flash -> mass analysis chain for heterogeneous media.

Counterpart of
:mod:`darsia_tpu.presets.workflows.heterogeneous_color_to_mass_analysis`:
the same three stages (``__call__``), setters, Nelder-Mead calibration
against the injected mass (scipy), save, ``from_folder``, ``load`` and the
headless calibration session.  Every stage runs on the device of the image
(the baseline's: the card unless the baseline was built on the CPU); the
labels, the density and solubility maps and the expert masks are copied to
a device once, and the host reads only the integrated masses a caller asks
for.  A saved folder is the JAX package's (per label
``signal_function_<label>.csv``, ``color_interpretation_<label>.json``, and
``flash.npz``); reading one goes through
:func:`darsia_tpu_torch.convert.chain_parts_from_calibration`.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ...analysis.concentrationanalysis import ConcentrationAnalysis
from ...convert import chain_parts_from_calibration
from ...signals.color.color_embedding import ColorEmbeddingBasis, parse_color_embedding_basis
from ...signals.color.color_mode import ColorMode
from ...signals.models.basemodel import HeterogeneousModel
from ...signals.models.clipmodel import ClipModel
from ...signals.models.combinedmodel import CombinedModel
from ...signals.models.pwtransformation import read_csv
from ...utils.npz import load_npz
from ...utils.optional import optional_module
from .simple_run_analysis import SimpleRunAnalysis

logger = logging.getLogger(__name__)

__all__ = ["HeterogeneousCalibrationSession", "HeterogeneousColorToMassAnalysis"]

_DEFAULT_FLASH = [0.0, 1.0, 1.0, 2.0]


def _label_of(file: Path) -> int:
    return int(file.stem.split("_")[-1])


def _read_calibration(folder: Path) -> dict:
    """A saved calibration folder as plain Python: the input of
    :func:`~darsia_tpu_torch.convert.chain_parts_from_calibration` (the
    flash's bounds None where the folder has no ``flash.npz``)."""
    folder = Path(folder)
    color_paths = {}
    for file in sorted(folder.glob("color_interpretation_*.json")):
        data = json.loads(file.read_text())
        color_paths[_label_of(file)] = {
            **data["color_path"],
            "color_mode": data["color_mode"],
            "values": data["values"],
            "ignore_spectrum": data.get("ignore_spectrum"),
        }
    signal_functions = {}
    for file in sorted(folder.glob("signal_function_*.csv")):
        supports, values = read_csv(file)
        signal_functions[_label_of(file)] = {"supports": supports, "values": values}
    flash_file = folder / "flash.npz"
    bounds = load_npz(flash_file, names=("values",))["values"] if flash_file.exists() else None
    return {"color_paths": color_paths, "signal_functions": signal_functions, "flash": bounds}


class HeterogeneousColorToMassAnalysis:
    """Full mass pipeline: colour interpretation -> pH -> flash -> mass."""

    def __init__(
        self,
        baseline,
        labels,
        color_mode: ColorMode,
        color_path_interpretation: dict,
        signal_functions: dict,
        flash,
        co2_mass_analysis,
        geometry,
        restoration=None,
        ignore_labels: Optional[list] = None,
        basis: ColorEmbeddingBasis = ColorEmbeddingBasis.LABELS,
        expert_knowledge_adapter=None,
        contour_smoother=None,
    ) -> None:
        base_model = CombinedModel(
            [HeterogeneousModel(color_path_interpretation, labels, ignore_labels=ignore_labels)]
        )
        config = {"diff option": "plain", "restoration -> model": False}
        self.color_analysis = ConcentrationAnalysis(
            base=baseline if color_mode == ColorMode.RELATIVE else None,
            restoration=None,
            model=base_model,
            labels=labels,
            **config,
        )

        # Clip colour signals into the common domain of the signal functions.
        functions = signal_functions.values()
        min_domain = max(min(np.asarray(f.supports)) for f in functions)
        max_domain = min(max(np.asarray(f.supports)) for f in functions)
        min_range = min(min(np.asarray(f.values)) for f in functions)
        max_range = max(max(np.asarray(f.values)) for f in functions)
        self.signal_model_extents = ((min_domain, max_domain), (min_range, max_range))

        signal_model = CombinedModel(
            [
                ClipModel(min_domain, max_domain),
                HeterogeneousModel(signal_functions, labels, ignore_labels=ignore_labels),
            ]
        )
        self.signal_model = ConcentrationAnalysis(
            base=None, restoration=restoration, model=signal_model, labels=labels, **config
        )

        self.flash = flash
        self.co2_mass_analysis = co2_mass_analysis
        self.geometry = geometry
        self.original_depth = geometry.depth.copy()
        self.analysis = SimpleRunAnalysis(self.geometry)
        self.color_path_interpretation = color_path_interpretation
        self.basis = parse_color_embedding_basis(basis)
        self.expert_knowledge_adapter = expert_knowledge_adapter
        self.contour_smoother = contour_smoother
        self.ignore_labels = list(ignore_labels or [])

    # ------------------------------------------------------------ pipeline

    @property
    def labels(self):
        assert self.color_analysis.labels is not None
        return self.color_analysis.labels

    def call_color_interpretation(self, image):
        return self.color_analysis(image)

    def call_pH_analysis(self, color_interpretation):
        return self.signal_model(color_interpretation)

    def call_flash_and_mass_analysis(self, pH):
        c_aq, s_g = self.flash(pH)
        if self.expert_knowledge_adapter is not None:
            c_aq = self.expert_knowledge_adapter.apply(c_aq, "concentration_aq")
            s_g = self.expert_knowledge_adapter.apply(s_g, "saturation_g")
        return self.co2_mass_analysis.mass_analysis(c_aq=c_aq, s_g=s_g)

    def __call__(self, image):
        color_interpretation = self.call_color_interpretation(image)
        pH = self.call_pH_analysis(color_interpretation)
        return self.call_flash_and_mass_analysis(pH)

    # ------------------------------------------------------------ setters

    def update_signal_function(self, label: int, values=None, supports=None):
        self.signal_model.model[1][int(label)].update(supports=supports, values=values)

    def update_flash(self, **kwargs) -> None:
        self.flash.update(**kwargs)

    # ------------------------------------------------------------ calibrate

    def manual_calibration_session(
        self, images: list, experiment, log=None
    ) -> "HeterogeneousCalibrationSession":
        """A propose -> preview -> accept stepper over the per-label signal
        functions and the flash bounds (the colour interpretation of each
        image is computed once)."""
        return HeterogeneousCalibrationSession(self, images, experiment, log)

    def manual_calibration(self, images: list, experiment, rois=None, cmap=None):
        """The stepper session (``rois`` and ``cmap`` accepted for the
        signature)."""
        return self.manual_calibration_session(images, experiment)

    def automatic_calibration(
        self, images: list, experiment, rois: Optional[dict] = None, maxiter: int = 10
    ) -> None:
        """Fit the signal functions' values and the flash bounds to the
        injected mass (Nelder-Mead over monotone value increments)."""
        from scipy.optimize import minimize

        functions = self.signal_model.model[1]
        available_labels = np.sort([l for l in functions.keys() if l not in self.ignore_labels])
        color_interpretations = [self.call_color_interpretation(image) for image in images]
        times = [
            float(np.asarray(img.time)) / 3600.0 if img.time is not None else 0.0
            for img in images
        ]
        expected = [float(experiment.injection_protocol.injected_mass(time=t)) for t in times]

        initial_dofs = np.hstack(
            [np.diff(np.asarray(functions[l].values)) for l in available_labels]
            + [
                self.flash.min_value_aq,
                self.flash.max_value_aq - self.flash.min_value_aq,
                self.flash.min_value_g,
                self.flash.max_value_g - self.flash.min_value_g,
            ]
        )
        logger.info("Number of DOFs for optimization: %d", len(initial_dofs))

        def _install(dofs: np.ndarray) -> None:
            idx = 0
            for label in available_labels:
                num_values = len(np.asarray(functions[label].values))
                new_values = np.cumsum(np.hstack([0.0, np.abs(dofs[idx : idx + num_values - 1])]))
                functions[label].update(values=new_values)
                idx += num_values - 1
            self.flash.update(
                min_value_aq=dofs[-4],
                max_value_aq=dofs[-4] + abs(dofs[-3]),
                min_value_g=dofs[-2],
                max_value_g=dofs[-2] + abs(dofs[-1]),
            )

        def objective(dofs: np.ndarray) -> float:
            _install(dofs)
            error = 0.0
            for interp, mass_expected in zip(color_interpretations, expected):
                result = self.call_flash_and_mass_analysis(self.call_pH_analysis(interp))
                integrated = float(self.geometry.integrate(result.mass))
                error += abs(integrated - mass_expected) / max(mass_expected, 1e-12)
            return error

        result = minimize(
            objective,
            initial_dofs,
            method="Nelder-Mead",
            bounds=[(0, 1)] * len(initial_dofs),
            options={"maxiter": maxiter, "xatol": 1e-6, "fatol": 1e-6},
        )
        _install(result.x)
        logger.info("Calibration finished: %s", result.message)

    # ------------------------------------------------------------------- io

    def save(self, folder: Path) -> None:
        """Write the signal functions, the flash and the colour
        interpretations, as the JAX package writes them."""
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        for label in self.signal_model.model[1].keys():
            self.signal_model.model[1][label].save(folder / f"signal_function_{label}.csv")
        self.flash.save(folder / "flash.npz")
        for label, interpretation in self.color_path_interpretation.items():
            interpretation.save(folder / f"color_interpretation_{label}.json")

    @classmethod
    def from_folder(
        cls,
        folder: Path,
        baseline,
        labels,
        co2_mass_analysis,
        geometry,
        restoration=None,
        basis: ColorEmbeddingBasis = ColorEmbeddingBasis.LABELS,
        expert_knowledge_adapter=None,
        contour_smoother=None,
        color_mode: ColorMode = ColorMode.RELATIVE,
        flash=None,
    ) -> "HeterogeneousColorToMassAnalysis":
        """A chain from a saved calibration folder (the default flash
        ``SimpleFlash(0, 1, 1, 2)`` where the folder has none)."""
        calibration = _read_calibration(folder)
        if calibration["flash"] is None:
            calibration["flash"] = _DEFAULT_FLASH
        interpretations, signal_functions, saved_flash = chain_parts_from_calibration(calibration)
        if not interpretations or not signal_functions:
            raise FileNotFoundError(f"No calibrated color-to-mass data found in {folder}.")
        return cls(
            baseline=baseline,
            labels=labels,
            color_mode=color_mode,
            color_path_interpretation=interpretations,
            signal_functions=signal_functions,
            flash=saved_flash if flash is None else flash,
            co2_mass_analysis=co2_mass_analysis,
            geometry=geometry,
            restoration=restoration,
            basis=basis,
            expert_knowledge_adapter=expert_knowledge_adapter,
            contour_smoother=contour_smoother,
        )

    def load(self, folder: Path) -> None:
        """Replace the signal functions, the flash bounds and the colour
        interpretations by a saved folder's."""
        folder = Path(folder)
        calibration = _read_calibration(folder)
        if calibration["flash"] is None:
            raise FileNotFoundError(f"File {folder / 'flash.npz'} not found.")
        interpretations, signal_functions, flash = chain_parts_from_calibration(calibration)
        for label, function in signal_functions.items():
            self.signal_model.model[1][label] = function
        self.flash.update(**flash.to_dict())
        for label, interpretation in interpretations.items():
            self.color_path_interpretation[label] = interpretation
            self.color_analysis.model[0][label] = interpretation


class HeterogeneousCalibrationSession:
    """Propose -> preview -> accept stepper for the heterogeneous chain: the
    controls are the per-label signal-function values and the flash bounds
    (keywords of :meth:`propose`); :meth:`preview` returns detected against
    expected masses; :meth:`accept` writes the iteration log."""

    def __init__(self, chain, images: list, experiment, log=None) -> None:
        self.chain = chain
        self.log = Path(log) if log is not None else None
        self.iterations: list[dict] = []
        self.color_interpretations = [chain.call_color_interpretation(image) for image in images]
        self.times = [
            float(np.asarray(img.time)) / 3600.0 if img.time is not None else 0.0
            for img in images
        ]
        self.expected = [
            float(experiment.injection_protocol.injected_mass(time=t)) for t in self.times
        ]

    def _evaluate(self) -> dict:
        detected = []
        for interp in self.color_interpretations:
            pH = self.chain.call_pH_analysis(interp)
            result = self.chain.call_flash_and_mass_analysis(pH)
            detected.append(float(self.chain.geometry.integrate(result.mass)))
        detected_arr = np.asarray(detected)
        expected_arr = np.asarray(self.expected)
        rel = np.abs(detected_arr - expected_arr) / np.maximum(expected_arr, 1e-12)
        return {
            "time": np.asarray(self.times),
            "detected_mass": detected_arr,
            "expected_mass": expected_arr,
            "error": float(np.square(detected_arr - expected_arr).sum()),
            "relative_errors": rel,
        }

    def propose(self, signal_values: Optional[dict] = None, flash_bounds: Optional[dict] = None):
        """Apply per-label signal-function values and/or flash bounds
        (min/max_value_aq, min/max_value_g) and evaluate."""
        if signal_values:
            for label, values in signal_values.items():
                self.chain.update_signal_function(int(label), values=values)
        if flash_bounds:
            self.chain.update_flash(**flash_bounds)
        metrics = self._evaluate()
        functions = self.chain.signal_model.model[1]
        self.iterations.append(
            {
                "iteration": len(self.iterations),
                "error": metrics["error"],
                "signal_values": {
                    int(l): np.array(functions[l].values, copy=True) for l in functions.keys()
                },
            }
        )
        return metrics

    def preview(self, path=None) -> dict:
        """The detected and expected masses; with ``path``, also plotted
        there."""
        metrics = self._evaluate()
        if path is not None:
            plt = optional_module(
                "matplotlib.pyplot", "HeterogeneousCalibrationSession.preview(path=...)"
            )

            fig, ax = plt.subplots()
            ax.plot(metrics["time"], metrics["detected_mass"], "o-", label="detected")
            ax.plot(metrics["time"], metrics["expected_mass"], "k--", label="expected")
            ax.set_xlabel("time [h]")
            ax.set_ylabel("mass [kg]")
            ax.legend()
            fig.savefig(Path(path))
            plt.close(fig)
        return metrics

    def accept(self):
        if self.log is not None:
            self.log.mkdir(parents=True, exist_ok=True)
            np.savez(
                self.log / "calibration_log.npz",
                error=np.asarray([it["error"] for it in self.iterations]),
            )
            self.chain.save(self.log / "calibrated")
        return self.chain
