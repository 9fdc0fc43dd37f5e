"""[labeling] section (parity: reference
``presets/workflows/config/labeling.py:12-50``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .toml_utils import Key, SectionConfig

__all__ = ["LabelingConfig"]


@dataclass
class LabelingConfig(SectionConfig):
    colored_image: Path = field(default_factory=Path)
    unite_labels: list = field(default_factory=list)
    water_label: Optional[int] = None
    colorchecker_label: Optional[int] = None
    labels: Path = field(default_factory=Path)
    rtol: float = 0.001
    ensure_connectivity: bool = True

    _section = "labeling"
    _spec = [
        Key("colored_image", Path, required=True),
        Key("unite_labels", list),
        Key("water_label", int),
        Key("colorchecker_label", int),
        Key("labels", Path),
        Key("rtol", float),
        Key("ensure_connectivity", bool),
    ]

    def _post_load(self, sec: dict, results=None, **_) -> None:
        if not sec.get("labels") and results is not None:
            self.labels = Path(results) / "setup" / "labels.npz"
