"""[helper] section (parity: reference
``presets/workflows/config/helper.py:15-249``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .time_data import TimeData
from .toml_utils import convert_none, get_section

__all__ = [
    "HelperRoiConfig",
    "HelperRoiViewerConfig",
    "HelperResultsConfig",
    "HelperColorConfig",
    "HelperConfig",
]


def _load_time_data(sec: dict, data_registry=None) -> Optional[TimeData]:
    if "data" not in sec:
        return None
    raw = sec["data"]
    if isinstance(raw, str) and data_registry is not None:
        return data_registry.resolve(raw)
    if isinstance(raw, dict):
        return TimeData().load(raw)
    return None


@dataclass
class HelperRoiConfig:
    mode: str = "none"
    data: Optional[TimeData] = None

    def load(self, sec: dict, data_registry=None) -> "HelperRoiConfig":
        self.mode = str(sec.get("mode", "none")).strip()
        self.data = _load_time_data(sec, data_registry)
        return self


@dataclass
class HelperRoiViewerConfig:
    data: Optional[TimeData] = None

    def load(self, sec: dict, data_registry=None) -> "HelperRoiViewerConfig":
        self.data = _load_time_data(sec, data_registry)
        return self


@dataclass
class HelperResultsConfig:
    data: Optional[TimeData] = None
    mode: str = "rescaled_mass"
    format: str = "npz"
    cmap: Optional[str] = None
    roi: Optional[list] = None

    def load(self, sec: dict, data_registry=None) -> "HelperResultsConfig":
        self.mode = str(sec["mode"]).strip()
        self.format = str(sec.get("format", "npz")).strip().lower()
        cmap = convert_none(sec.get("cmap"))
        self.cmap = None if cmap is None else str(cmap)
        roi = convert_none(sec.get("roi"))
        if roi is not None:
            self.roi = [roi] if isinstance(roi, str) else list(roi)
        self.data = _load_time_data(sec, data_registry)
        return self


@dataclass
class HelperColorConfig:
    data: Optional[TimeData] = None

    def load(self, sec: dict, data_registry=None) -> "HelperColorConfig":
        self.data = _load_time_data(sec, data_registry)
        return self


@dataclass
class HelperConfig:
    data: Optional[TimeData] = None
    roi: Optional[HelperRoiConfig] = None
    roi_viewer: Optional[HelperRoiViewerConfig] = None
    results: Optional[HelperResultsConfig] = None
    color: Optional[HelperColorConfig] = None

    def load(self, path, data_registry=None) -> "HelperConfig":
        sec = get_section(path, "helper")
        self.data = _load_time_data(sec, data_registry)
        sub_loaders = {
            "roi": HelperRoiConfig,
            "roi_viewer": HelperRoiViewerConfig,
            "results": HelperResultsConfig,
            "color": HelperColorConfig,
        }
        for name, cls in sub_loaders.items():
            if name in sec and isinstance(sec[name], dict):
                setattr(
                    self, name, cls().load(sec[name], data_registry=data_registry)
                )
        return self
