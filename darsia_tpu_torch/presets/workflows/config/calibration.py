"""[calibration] section (parity: reference
``presets/workflows/config/calibration.py:20-149``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .time_data import TimeData
from .toml_utils import get_section, validate_choice

__all__ = ["CalibrationColorConfig", "CalibrationMassConfig", "CalibrationConfig"]


def _resolve_color(sub_sec: dict, color_embedding_registry, context: str):
    color_key = str(sub_sec["color"]).strip()
    if color_embedding_registry is None:
        raise ValueError(
            f"{context}.color references [color.*.*], but no "
            "ColorEmbeddingRegistry is available."
        )
    try:
        return color_embedding_registry.resolve(color_key)
    except KeyError as exc:
        raise ValueError(f"Unknown {context}.color {color_key!r}.") from exc


@dataclass
class CalibrationColorConfig:
    color: object = None

    def load(
        self, sec: dict, color_embedding_registry=None
    ) -> "CalibrationColorConfig":
        sub_sec = get_section(sec, "color")
        self.color = _resolve_color(
            sub_sec, color_embedding_registry, "calibration.color"
        )
        return self


@dataclass
class CalibrationMassConfig:
    color: object = None
    mode: str = "manual"
    fluid: Optional[str] = "co2"
    data: Optional[TimeData] = None
    threshold: float = 0.2
    rois: list = field(default_factory=list)
    maxiter: int = 20

    def load(
        self, sec: dict, color_embedding_registry=None, data_registry=None
    ) -> "CalibrationMassConfig":
        sub_sec = get_section(sec, "mass")
        self.color = _resolve_color(
            sub_sec, color_embedding_registry, "calibration.mass"
        )
        self.mode = validate_choice(
            str(sub_sec.get("mode", "manual")).strip(),
            allowed={"manual", "auto"},
            context="calibration.mass",
            key="mode",
        )
        self.fluid = str(sub_sec.get("fluid", "co2")).strip()
        self.threshold = float(sub_sec.get("threshold", 0.2))
        self.maxiter = int(sub_sec.get("maxiter", 20))
        self.rois = list(sub_sec.get("rois", []))
        if "data" in sub_sec:
            if data_registry is not None and isinstance(sub_sec["data"], str):
                self.data = data_registry.resolve(sub_sec["data"])
            elif isinstance(sub_sec["data"], dict):
                self.data = TimeData().load(sub_sec["data"])
        return self


@dataclass
class CalibrationConfig:
    color: Optional[CalibrationColorConfig] = None
    mass: Optional[CalibrationMassConfig] = None
    data: Optional[TimeData] = None

    def load(
        self, path, color_embedding_registry=None, data_registry=None
    ) -> "CalibrationConfig":
        sec = get_section(path, "calibration")
        if "data" in sec:
            if data_registry is not None and isinstance(sec["data"], str):
                self.data = data_registry.resolve(sec["data"])
            elif isinstance(sec["data"], dict):
                self.data = TimeData().load(sec["data"])
        try:
            self.color = CalibrationColorConfig().load(
                sec, color_embedding_registry=color_embedding_registry
            )
        except KeyError:
            self.color = None
        try:
            self.mass = CalibrationMassConfig().load(
                sec,
                color_embedding_registry=color_embedding_registry,
                data_registry=data_registry,
            )
        except KeyError:
            self.mass = None
        return self
