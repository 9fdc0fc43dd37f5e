"""Colour-path interpolation models: colours -> scalar signal.

Counterpart of :mod:`darsia_tpu.signals.models.color_path_interpolation`
(``ColorPathFunction``, ``ColorPathInterpolation``,
``LabelColorPathInterpolation``).  Everything stays on the colours' device
in float32: the parametrization (``ColorPath.fit``), the piecewise-linear
values at the path's nodes (:func:`~darsia_tpu_torch.ops.interp.interp`) and
the linear extrapolation past the end nodes.  With an ``ignore_spectrum``,
colours of norm <= 0.1 take parameter 0 through a ``torch.where`` (the JAX
package fits only the others: the same values, without a boolean gather).
Only whether an ``ignore_spectrum`` (a
:class:`~darsia_tpu_torch.signals.color.color_range.ColorSpectrum`) is given
matters to the evaluation; it is saved and read back as the JAX package's.
"""

from __future__ import annotations

import abc
import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ...image.image import Image, as_tensor
from ...multiphase.mass_analysis import full_like
from ...ops.interp import interp
from ..color.color_mode import ColorMode
from ..color.color_path import ColorPath
from ..color.color_range import ColorSpectrum
from .basemodel import Model

__all__ = ["ColorPathFunction", "ColorPathInterpolation", "LabelColorPathInterpolation"]


class ColorPathFunction(Model):
    """Model defined through a colour path."""

    def __init__(self, color_path, color_mode: ColorMode) -> None:
        self.color_path = color_path
        self.color_mode = color_mode

    @abc.abstractmethod
    def update_model_parameters(self, parameters, dofs=None) -> None: ...

    @abc.abstractmethod
    def __call__(self, image): ...


class ColorPathInterpolation(ColorPathFunction):
    """Parametrize colours along a path, then map the parameter through
    piecewise-linear values at the path's nodes."""

    def __init__(
        self,
        color_path,
        color_mode: ColorMode,
        values: Optional[Union[np.ndarray, list]] = None,
        ignore_spectrum=None,
    ) -> None:
        super().__init__(color_path, color_mode)
        self.values = np.asarray(
            values if values is not None else color_path.equidistant_distances, dtype=float
        )
        assert len(self.values) == color_path.num_segments + 1, (
            "Length of values must match number of segments + 1."
        )
        self.ignore_spectrum = ignore_spectrum
        self._on_device: dict = {}

    def __str__(self) -> str:
        return (
            f"ColorPathInterpolation(color_mode={self.color_mode}, "
            f"values={self.values.tolist()})"
        )

    __repr__ = __str__

    def update_model_parameters(self, parameters, dofs=None) -> None:
        self.values = np.asarray(parameters, dtype=float)

    def calibrate(self):
        raise NotImplementedError("ColorPathInterpolation does not support calibration.")

    # ------------------------------------------------------------------- io

    def to_dict(self) -> dict:
        return {
            "color_path": self.color_path.to_dict(),
            "color_mode": str(
                self.color_mode.value if isinstance(self.color_mode, ColorMode) else self.color_mode
            ),
            "values": self.values.tolist(),
            "ignore_spectrum": self.ignore_spectrum.to_dict() if self.ignore_spectrum else None,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ColorPathInterpolation":
        return cls(
            color_path=ColorPath.from_dict(data["color_path"]),
            color_mode=ColorMode(data["color_mode"]),
            values=np.asarray(data["values"]),
            ignore_spectrum=(
                ColorSpectrum.from_dict(data["ignore_spectrum"])
                if data.get("ignore_spectrum")
                else None
            ),
        )

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: Path) -> "ColorPathInterpolation":
        return cls.from_dict(json.loads(Path(path).with_suffix(".json").read_text()))

    # ------------------------------------------------------------- evaluate

    def _nodes(self, device) -> dict:
        """The nodes, values and end slopes as float32 tensors on ``device``."""
        nodes = np.asarray(self.color_path.equidistant_distances, dtype=np.float32)
        values = np.asarray(self.values, dtype=np.float32)
        fingerprint = nodes.tobytes() + values.tobytes()
        held = self._on_device.get(device)
        if held is None or held[0] != fingerprint:
            x = torch.from_numpy(nodes).to(device)
            f = torch.from_numpy(values).to(device)
            table = {
                "nodes": x,
                "values": f,
                "lo_slope": (f[1] - f[0]) / (x[1] - x[0]),
                "hi_slope": (f[-1] - f[-2]) / (x[-1] - x[-2]),
            }
            held = self._on_device[device] = (fingerprint, table)
        return held[1]

    def call_array(self, colors) -> torch.Tensor:
        """Colours (..., 3) -> interpolated float32 values (...) on the
        colours' device (a numpy array goes to the card)."""
        colors = as_tensor(colors)
        p = self.color_path.fit(colors=colors, color_mode=self.color_mode, mode="equidistant")
        if self.ignore_spectrum is not None and colors.dim() > 1:
            norm = torch.linalg.vector_norm(colors.to(torch.float64), dim=-1)
            p = torch.where(norm > 1e-1, p, 0.0)
        table = self._nodes(p.device)
        nodes, vals = table["nodes"], table["values"]
        out = interp(p, nodes, vals)
        # Linear extrapolation past the end nodes with the end segments' slopes.
        out = torch.where(p < nodes[0], vals[0] + (p - nodes[0]) * table["lo_slope"], out)
        return torch.where(p > nodes[-1], vals[-1] + (p - nodes[-1]) * table["hi_slope"], out)

    def __call__(self, image):
        if isinstance(image, Image):
            return full_like(image, self.call_array(image.img))
        return self.call_array(image)


class LabelColorPathInterpolation(Model):
    """Per-label colour-path interpolation blended by a label field (each
    label's model on the whole array, kept where the label is)."""

    def __init__(
        self,
        color_paths: dict,
        labels,
        color_mode: ColorMode,
        values: Optional[dict] = None,
    ) -> None:
        self.color_mode = color_mode
        labels = labels.img if hasattr(labels, "img") else labels
        self.labels = labels if isinstance(labels, torch.Tensor) else torch.from_numpy(labels)
        self.models = {
            label: ColorPathInterpolation(
                path, color_mode, values=values.get(label) if values else None
            )
            for label, path in color_paths.items()
        }
        self._on_device = {self.labels.device: self.labels}

    def update_model_parameters(self, parameters, dofs=None) -> None:
        for label, params in parameters.items():
            self.models[label].update_model_parameters(params)

    def call_array(self, colors) -> torch.Tensor:
        colors = as_tensor(colors)
        labels = self._on_device.get(colors.device)
        if labels is None:
            labels = self._on_device[colors.device] = self.labels.to(colors.device)
        out = torch.zeros(colors.shape[:-1], dtype=torch.float32, device=colors.device)
        for label, model in self.models.items():
            out = torch.where(labels == label, model.call_array(colors), out)
        return out

    def __call__(self, image):
        if isinstance(image, Image):
            return full_like(image, self.call_array(image.img))
        return self.call_array(image)
