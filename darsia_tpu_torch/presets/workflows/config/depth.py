"""[depth] section (parity: reference ``presets/workflows/config/depth.py:12-30``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .toml_utils import Key, SectionConfig

__all__ = ["DepthConfig"]


@dataclass
class DepthConfig(SectionConfig):
    measurements: Path = field(default_factory=Path)
    depth_map: Path = field(default_factory=Path)

    _section = "depth"
    _spec = [
        Key("measurements", Path, required=True),
        Key("depth_map", Path),
    ]

    def _post_load(self, sec: dict, results=None, **_) -> None:
        if not sec.get("depth_map") and results is not None:
            self.depth_map = Path(results) / "setup" / "depth_map.npz"
