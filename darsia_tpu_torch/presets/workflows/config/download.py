"""[download] section (parity: reference
``presets/workflows/config/download.py:15-60``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .time_data import TimeData
from .toml_utils import get_section

__all__ = ["DownloadConfig"]


@dataclass
class DownloadConfig:
    source: Optional[Path] = None
    data: Optional[TimeData] = None
    skip_existing: bool = True
    folder: Optional[Path] = None

    def load(self, path) -> "DownloadConfig":
        sec = get_section(path, "download")
        self.source = Path(sec["source"]) if "source" in sec else None
        if isinstance(sec.get("data"), dict):
            self.data = TimeData().load(sec["data"])
        self.skip_existing = bool(sec.get("skip_existing", True))
        self.folder = Path(sec["folder"]) if "folder" in sec else None
        return self
