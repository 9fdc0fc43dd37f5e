"""[rig] section (parity: reference ``presets/workflows/config/rig.py:8-38``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .toml_utils import Key, SectionConfig, get_section

__all__ = ["RigConfig"]


@dataclass
class RigConfig(SectionConfig):
    width: float = 0.0
    height: float = 0.0
    dim: int = 2
    resolution: tuple = (500, 1000)
    path: Path = field(default_factory=Path)

    _section = "rig"
    _spec = [
        Key("width", float, required=True),
        Key("height", float, required=True),
        Key("dim", int, required=True),
        Key("resolution", tuple),
        Key("path", Path),
    ]

    def _post_load(self, sec: dict, results=None, **_) -> None:
        if not sec.get("path"):
            assert results is not None, "[rig].path or results folder required."
            self.path = Path(results) / "setup" / "rig"
