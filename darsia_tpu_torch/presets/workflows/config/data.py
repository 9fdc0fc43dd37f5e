"""[data] section: image folders, baseline, results, cache.

Parity: reference ``presets/workflows/config/data.py:15-190`` and
``data_registry.py`` (named sub-selections).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .time_data import TimeData
from .toml_utils import SectionConfig, get_key, get_section

__all__ = ["DataConfig", "DataRegistry"]


@dataclass
class DataRegistry:
    """Named time/path selections under [data.interval.*], [data.time.*],
    [data.path.*] (reference data_registry.py:19-211)."""

    selections: dict = field(default_factory=dict)

    def load(self, sec: dict, folder) -> "DataRegistry":
        for name, interval in sec.get("interval", {}).items():
            data = TimeData()
            data.load({"interval": {name: interval}})
            self.selections[name] = data
        for name, times in sec.get("time", {}).items():
            data = TimeData()
            data.load(times if isinstance(times, dict) else {"times": times})
            self.selections[name] = data
        for name, paths in sec.get("path", {}).items():
            data = TimeData()
            data.load(paths if isinstance(paths, dict) else {"paths": paths})
            self.selections[name] = data
        return self

    def get(self, name: str) -> Optional[TimeData]:
        return self.selections.get(name)

    def keys(self) -> list:
        """Sorted names of all registered selections (reference
        data_registry.py:205-211)."""
        return sorted(self.selections)

    def resolve(self, name) -> TimeData:
        if name is None or name not in self.selections:
            raise KeyError(
                f"Data selection {name!r} not found. "
                f"Available: {list(self.selections)}."
            )
        return self.selections[name]

    def __contains__(self, name: str) -> bool:
        return name in self.selections


@dataclass
class DataConfig(SectionConfig):
    """[data] section."""

    folder: Path = field(default_factory=Path)
    folders: list = field(default_factory=list)
    format: str = "JPG"
    data: Optional[list] = field(default_factory=list)
    baseline: Path = field(default_factory=Path)
    pad: int = 0
    results: Path = field(default_factory=Path)
    cache: Optional[Path] = None
    raw_cache: Optional[Path] = None
    use_cache: bool = False
    time_data: Optional[TimeData] = None
    registry: Optional[DataRegistry] = None

    _section = "data"
    _spec = []  # fully custom parsing below

    def load(
        self,
        path,
        require_data: bool = False,
        require_results: bool = False,
    ) -> "DataConfig":
        sec = get_section(path, "data")

        folder_value = sec.get("folder")
        folders_value = sec.get("folders")
        if folder_value is None and folders_value is None:
            raise KeyError("Missing key 'folder' or 'folders' in [data].")
        self.folders = []
        if folder_value is not None:
            self.folder = Path(folder_value)
            self.folders.append(self.folder)
        if folders_value is not None:
            if not isinstance(folders_value, list) or not folders_value:
                raise ValueError("[data].folders must be a non-empty list.")
            for f in folders_value:
                f = Path(f)
                if f not in self.folders:
                    self.folders.append(f)
            if folder_value is None:
                self.folder = self.folders[0]
        if require_data:
            for f in self.folders:
                if not f.is_dir():
                    raise FileNotFoundError(f"Folder {f} not found.")

        baseline = Path(get_key(sec, "baseline", required=True))
        if baseline.is_absolute():
            self.baseline = baseline
        else:
            candidates = [f / baseline for f in self.folders]
            existing = [c for c in candidates if c.is_file()]
            self.baseline = existing[0] if existing else self.folder / baseline
        if require_data and not self.baseline.is_file():
            raise FileNotFoundError(f"Baseline image {self.baseline} not found.")

        self.format = get_key(sec, "format", default=self.format, required=False)
        numeric = "".join(filter(str.isdigit, self.baseline.stem))
        self.pad = len(numeric)

        if require_data:
            all_data = []
            for f in self.folders:
                all_data.extend(
                    sorted(
                        f / name
                        for name in os.listdir(f)
                        if name.endswith(self.baseline.suffix)
                    )
                )
            self.data = sorted(set(all_data))
            if not self.data:
                raise FileNotFoundError(
                    f"No images with suffix {self.baseline.suffix} in {self.folders}."
                )
        else:
            self.data = None

        self.results = Path(get_key(sec, "results", required=True))
        if require_results:
            if not self.results.is_dir():
                raise FileNotFoundError(
                    f"Results folder {self.results} not found."
                )
        else:
            self.results.mkdir(parents=True, exist_ok=True)

        self.use_cache = bool(sec.get("use_cache", False))
        if self.use_cache:
            self.cache = self.results / "cache"
            self.raw_cache = self.results / "raw_cache"
            self.cache.mkdir(parents=True, exist_ok=True)
            self.raw_cache.mkdir(parents=True, exist_ok=True)
        else:
            self.cache = None

        if any(key in sec for key in ("interval", "time", "path")):
            self.registry = DataRegistry().load(
                sec, self.folders if len(self.folders) > 1 else self.folder
            )
        else:
            self.registry = None
        return self
