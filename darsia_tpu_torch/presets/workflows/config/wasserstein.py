"""[wasserstein] comparison section (parity: reference
``presets/workflows/config/wasserstein.py:15-120``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .roi import RoiConfig
from .time_data import TimeData
from .toml_utils import get_section

__all__ = ["WassersteinDistancesConfig"]


@dataclass
class WassersteinDistancesConfig:
    results: Path = field(default_factory=Path)
    runs: list = field(default_factory=list)
    resize_factor: Optional[float] = None
    relative_tol: Optional[float] = None
    roi: Optional[dict] = None
    times: list = field(default_factory=list)

    def load(self, path, results=None, roi=None) -> "WassersteinDistancesConfig":
        sec = get_section(path, "wasserstein")
        raw_results = sec.get("results")
        self.results = (
            Path(raw_results) if raw_results else Path(results) / "wasserstein"
        )
        self.results.mkdir(parents=True, exist_ok=True)
        self.runs = list(sec["runs"])
        self.resize_factor = (
            float(sec["resize"]) if "resize" in sec else None
        )
        self.relative_tol = (
            float(sec["relative_tol"]) if "relative_tol" in sec else None
        )
        time_data = TimeData().load(sec)
        tol = time_data.default_tol
        self.times = [(t, tol) for t in time_data.all_times()]
        if isinstance(sec.get("roi"), dict):
            self.roi = {
                key: RoiConfig().load(entry)
                for key, entry in sec["roi"].items()
            }
        elif isinstance(sec.get("roi"), list) and roi is not None:
            self.roi = {key: roi.roi[key] for key in sec["roi"]}
        return self
