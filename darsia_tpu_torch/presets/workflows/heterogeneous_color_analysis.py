"""Heterogeneous (per-label) colour-path concentration analysis.

Counterpart of :mod:`darsia_tpu.presets.workflows.heterogeneous_color_analysis`
with the same programmatic calibration (explicit colour paths and values in
place of the interactive pickers).  As there, ``color_path_associations`` is
sized by the number of labels and indexed by a label's value, so labels
that do not run from 0 to L - 1 raise an ``IndexError``.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...analysis.concentrationanalysis import ConcentrationAnalysis
from ...image.image import as_numpy
from ...signals.color.color_mode import ColorMode
from ...signals.color.color_path import ColorPath, define_color_path
from ...signals.models.basemodel import HeterogeneousModel
from ...signals.models.clipmodel import ClipModel
from ...signals.models.color_path_interpolation import ColorPathInterpolation
from ...signals.models.combinedmodel import CombinedModel
from ...utils.optional import optional_module

__all__ = ["HeterogeneousColorAnalysis"]


def _default_interpolation(color_mode: ColorMode) -> ColorPathInterpolation:
    return ColorPathInterpolation(
        color_path=ColorPath(
            colors=[0.0 * np.ones(3), 0.5 * np.ones(3), 1.0 * np.ones(3)],
            base_color=np.zeros(3),
            mode="rgb",
        ),
        color_mode=color_mode,
    )


def _label_array(labels) -> np.ndarray:
    return as_numpy(labels.img if hasattr(labels, "img") else labels)


class HeterogeneousColorAnalysis(ConcentrationAnalysis):
    """Colour-based concentration analysis with per-label colour paths."""

    def __init__(
        self,
        baseline,
        labels,
        color_mode: ColorMode,
        color_path_functions: Optional[dict] = None,
        restoration=None,
        ignore_labels: Optional[list] = None,
    ) -> None:
        model = CombinedModel(
            [
                HeterogeneousModel(
                    _default_interpolation(color_mode), labels, ignore_labels=ignore_labels
                ),
                ClipModel(min_value=0.0, max_value=None),
            ]
        )
        config = {"diff option": "plain", "restoration -> model": False}
        super().__init__(
            base=baseline if color_mode == ColorMode.RELATIVE else None,
            restoration=restoration,
            labels=labels,
            model=model,
            **config,
        )
        self.color_mode = color_mode
        unique = np.unique(_label_array(labels))
        self.color_path_associations = np.zeros(unique.size, dtype=int)
        self.color_path_functions: list = []
        if color_path_functions:
            self.color_path_associations = unique.astype(int)
            self.color_path_functions = list(color_path_functions.values())
            for label, function in color_path_functions.items():
                self.model[0][label] = copy.copy(function)

    # ------------------------------------------------------------ calibrate

    def define_color_path(self, image, mask, num_colors: int = 5, name: str = "ColorPath"):
        """A colour path from masked pixels (relative to the baseline in the
        relative mode)."""
        data = image
        if self.color_mode == ColorMode.RELATIVE and self.base is not None:
            data = image.copy()
            data.img = image.img - self.base.img.to(image.img.device)
        return define_color_path(data, mask, num_colors=num_colors, name=name)

    def global_calibration_colors(self, image, mask, color_path: Optional[ColorPath] = None):
        """Assign one (derived or given) colour path to all labels."""
        if color_path is None:
            color_path = self.define_color_path(image, mask)
        self.global_color_path = color_path
        self.color_paths = [color_path]
        unique = np.unique(_label_array(self.labels))
        self.color_path_associations = np.zeros(unique.size, dtype=int)
        for label in unique:
            self._assign_color_path(int(label), color_path)

    def _assign_color_path(self, label: int, color_path: ColorPath) -> None:
        model = self.model[0][label]
        model.color_path = copy.copy(color_path)
        # A path with another node count invalidates the value table.
        if len(model.values) != color_path.num_segments + 1:
            model.values = np.asarray(color_path.equidistant_distances)

    def local_calibration_colors(self, label: int, image, mask, color_path=None) -> None:
        """Assign a dedicated colour path to one label."""
        if color_path is None:
            color_path = self.define_color_path(image, mask)
        if not hasattr(self, "color_paths"):
            self.color_paths = []
        self.color_paths.append(color_path)
        self.color_path_associations[int(label)] = len(self.color_paths) - 1
        self._assign_color_path(int(label), color_path)

    def local_calibration_values(self, label: int, values) -> None:
        """Set the interpolation values of one label's path."""
        self.model[0][int(label)].update_model_parameters(values)

    def calibration_values(
        self, image, initial_color_path_idx: int = 0, values: Optional[dict] = None
    ) -> dict:
        """Set the value tables of colour paths (path index -> values, pushed
        to every label of that path) and return the concentration previews
        (path index -> concentration tensor, 0 outside the path's labels)."""
        values = values or {}
        for idx, new_values in values.items():
            for label in np.where(self.color_path_associations == int(idx))[0]:
                self.model[0][int(label)].update_model_parameters(
                    np.asarray(new_values, dtype=float)
                )
        data = self(image).img
        labels = self.labels.img if hasattr(self.labels, "img") else self.labels
        labels = torch.as_tensor(labels).to(data.device)
        indices = sorted({int(i) for i in values}) if values else [int(initial_color_path_idx)]
        previews: dict = {}
        for idx in indices:
            mask = torch.zeros(labels.shape, dtype=torch.bool, device=data.device)
            for label in np.where(self.color_path_associations == idx)[0]:
                mask |= labels == int(label)
            previews[idx] = torch.where(mask, data, 0.0)
        return previews

    def global_calibration_flash(
        self, mass_computation, mask, calibration_images: list, experiment, cmap=None, show=False
    ) -> dict:
        """The integrated mass of the calibration images against the
        injection protocol: the time series and its square error (with
        ``show``, also plotted)."""
        times, expected, integrated = [], [], []
        for img in calibration_images:
            time_h = float(np.asarray(img.time)) / 3600.0 if img.time is not None else 0.0
            signal = self(img)
            times.append(time_h)
            expected.append(float(experiment.injection_protocol.injected_mass(time=time_h)))
            integrated.append(float(mass_computation.integrated_mass(signal)))
        square_error = float(np.sum((np.asarray(integrated) - np.asarray(expected)) ** 2))
        history = {
            "times": times,
            "expected_mass": expected,
            "integrated_mass": integrated,
            "square_error": square_error,
        }
        self.calibration_history = history
        if show:
            plt = optional_module("matplotlib.pyplot", "global_calibration_flash(show=True)")

            plt.figure("Global flash calibration")
            plt.plot(times, expected, label="expected", color="k")
            plt.plot(times, integrated, label="integrated", color="b")
            plt.legend()
            plt.show()
        return history

    def local_calibration_flash(
        self, mass_computation, mask, calibration_images: list, cmap=None, show=False
    ) -> None:
        """Unimplemented in the JAX package as in its reference."""
        raise NotImplementedError(
            "local_calibration_flash is unimplemented upstream; combine "
            "local_calibration_colors with global_calibration_flash."
        )

    def local_calibration_color_path(
        self, image, mask, label: Optional[int] = None, label_box: Optional[tuple] = None
    ) -> int:
        """Define a dedicated colour path for one label (given, or the
        dominant label of a voxel-slice box); returns the label."""
        if label is None:
            assert label_box is not None, "Provide label= or label_box=."
            labels = self.labels.img if hasattr(self.labels, "img") else self.labels
            box = as_numpy(labels[label_box]).ravel()
            label = int(np.argmax(np.bincount(box)))
        self.local_calibration_colors(int(label), image, mask)
        return int(label)

    def update_color_path_function(self, label: int, function) -> None:
        self.model[0][int(label)] = copy.copy(function)
        self.color_path_functions.append(function)

    # ------------------------------------------------------------------- I/O

    def save(self, path) -> None:
        """The per-label colour-path calibration as JSON: one entry per
        distinct path (base colour, colours, the values of each of its
        labels, and the shared legacy table)."""
        paths = getattr(self, "color_paths", None)
        if not paths:
            raise ValueError("Nothing to save: run global/local_calibration_colors first.")
        payload = {
            str(path_id): {
                "base_color": np.asarray(color_path.base_color).tolist(),
                "colors": [np.asarray(c).tolist() for c in color_path.colors],
                "values": [],
                "values_per_label": {},
                "labels": [],
            }
            for path_id, color_path in enumerate(paths)
        }
        for label in np.unique(_label_array(self.labels)):
            entry = payload[str(int(self.color_path_associations[int(label)]))]
            entry["labels"].append(int(label))
            values = [float(v) for v in np.asarray(self.model[0][int(label)].values).ravel()]
            entry["values_per_label"][str(int(label))] = values
            entry["values"] = values
        out = Path(path).with_suffix(".json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=2))

    def load(self, path) -> None:
        """Restore a calibration written by :meth:`save`."""
        data = json.loads(Path(path).with_suffix(".json").read_text())
        self.color_paths = []
        self.color_path_associations = np.zeros(
            np.unique(_label_array(self.labels)).size, dtype=int
        )
        for path_id, entry in data.items():
            color_path = ColorPath(
                colors=[np.asarray(c, dtype=float) for c in entry["colors"]],
                base_color=np.asarray(entry["base_color"], dtype=float),
                mode="rgb",
            )
            self.color_paths.append(color_path)
            per_label = entry.get("values_per_label", {})
            for label in entry["labels"]:
                self.color_path_associations[int(label)] = int(path_id)
                self._assign_color_path(int(label), color_path)
                values = per_label.get(str(int(label)), entry.get("values"))
                if values:
                    self.model[0][int(label)].update_model_parameters(
                        np.asarray(values, dtype=float)
                    )
