"""[protocol] section (parity: reference
``presets/workflows/config/protocol.py:12-60``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .toml_utils import SectionConfig, get_section

__all__ = ["ProtocolConfig"]


def _parse_path_spec(value):
    """Path, [path, key] pair, or dict of named specs."""
    if value is None:
        return None
    if isinstance(value, str):
        return Path(value)
    if isinstance(value, list) and len(value) == 2:
        return (Path(value[0]), str(value[1]))
    if isinstance(value, dict):
        return {Path(k): _parse_path_spec(v) for k, v in value.items()}
    raise ValueError(f"Invalid protocol path spec: {value!r}.")


@dataclass
class ProtocolConfig(SectionConfig):
    imaging = None
    injection = None
    blacklist = None
    pressure_temperature = None
    imaging_mode: str = "exif"

    _section = "protocol"
    _spec = []

    def load(self, path, **_) -> "ProtocolConfig":
        # The reference TOML section is [protocols]; accept both spellings.
        try:
            sec = get_section(path, "protocols")
        except KeyError:
            sec = get_section(path, "protocol")
        self.imaging = _parse_path_spec(sec.get("imaging"))
        self.injection = _parse_path_spec(sec.get("injection"))
        self.blacklist = _parse_path_spec(sec.get("blacklist"))
        self.pressure_temperature = _parse_path_spec(
            sec.get("pressure_temperature")
        )
        self.imaging_mode = sec.get("imaging_mode", "exif")
        return self
