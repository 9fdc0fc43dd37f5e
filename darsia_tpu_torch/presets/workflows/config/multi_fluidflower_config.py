"""Multi-run configuration for cross-run comparison.

Parity: reference
``presets/workflows/config/multi_fluidflower_config.py:14-235``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional
from warnings import warn

from .fluidflower_config import FluidFlowerConfig
from .roi import MultiRoiConfig
from .toml_utils import get_section
from .wasserstein import WassersteinDistancesConfig

__all__ = [
    "MultiFluidFlowerRunsConfig",
    "MultiFluidFlowerDataConfig",
    "EventConfig",
    "EventsConfig",
    "MultiFluidFlowerConfig",
]


@dataclass
class MultiFluidFlowerRunsConfig:
    config: dict = field(default_factory=dict)

    def load(
        self, path: Path, require_data: bool, require_results: bool
    ) -> "MultiFluidFlowerRunsConfig":
        path = Path(path)
        run_section = get_section(path, "run")
        common_paths = []
        common = run_section.get("common", {})
        if "config" in common:
            raw = common["config"]
            raw = [raw] if isinstance(raw, str) else list(raw)
            common_paths = [path.parent / p for p in raw]
        for run_id, run_config in run_section.items():
            if run_id == "common":
                continue
            key = int(run_id) if str(run_id).isdigit() else run_id
            config_paths = [path.parent / run_config["config"]] + common_paths
            self.config[key] = FluidFlowerConfig(
                config_paths,
                require_data=require_data,
                require_results=require_results,
            )
        return self


@dataclass
class MultiFluidFlowerDataConfig:
    results: Path = field(default_factory=Path)

    def load(self, path) -> "MultiFluidFlowerDataConfig":
        sec = get_section(path, "data")
        self.results = Path(sec["results"])
        self.results.mkdir(parents=True, exist_ok=True)
        return self


@dataclass
class EventConfig:
    event_id: str = ""
    mode: str = ""
    roi_name: str = ""
    relative_threshold: float = 0.0

    def load(self, event_id: str, event_data: dict) -> "EventConfig":
        self.event_id = event_id
        self.mode = str(event_data["mode"])
        self.roi_name = str(event_data["roi_name"])
        self.relative_threshold = float(
            event_data.get("relative_threshold", 0.0)
        )
        return self


@dataclass
class EventsConfig:
    events: dict = field(default_factory=dict)
    path: Optional[Path] = None

    def load(self, path, results=None) -> "EventsConfig":
        sec = get_section(path, "events")
        for event_id, event_data in sec.items():
            if isinstance(event_data, dict):
                self.events[event_id] = EventConfig().load(event_id, event_data)
        if "path" in sec:
            self.path = Path(sec["path"])
        elif results is not None:
            self.path = Path(results) / "events" / "events.csv"
        return self


class MultiFluidFlowerConfig:
    """Aggregated multi-run configuration for comparisons."""

    def __init__(
        self,
        path,
        require_data: bool = False,
        require_results: bool = False,
    ) -> None:
        path = Path(path)
        self.path = path

        try:
            self.runs = MultiFluidFlowerRunsConfig().load(
                path, require_data=require_data, require_results=require_results
            )
        except KeyError:
            self.runs = None
            warn(f"Section run not found in {path}, use [run].")

        try:
            self.data = MultiFluidFlowerDataConfig().load(path)
        except KeyError:
            self.data = None
            warn(f"Section data not found in {path}, use [data].")
        results = self.data.results if self.data else None

        try:
            self.events = EventsConfig().load(path, results=results)
        except KeyError:
            self.events = None

        try:
            self.roi = MultiRoiConfig().load(path)
        except KeyError:
            self.roi = None

        try:
            self.wasserstein = WassersteinDistancesConfig().load(
                path, results=results, roi=self.roi
            )
        except KeyError:
            self.wasserstein = None

    def check(self, *sections: str) -> None:
        missing = [s for s in sections if getattr(self, s, None) is None]
        if missing:
            raise ValueError(
                f"Config {self.path} is missing required sections: {missing}."
            )
