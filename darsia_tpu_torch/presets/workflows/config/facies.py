"""[facies] section (parity: reference
``presets/workflows/config/facies.py:12-60``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .toml_utils import Key, SectionConfig

__all__ = ["FaciesConfig"]


@dataclass
class FaciesConfig(SectionConfig):
    props: Path = field(default_factory=Path)
    path: Path = field(default_factory=Path)
    facies_to_labels_map: dict = field(default_factory=dict)
    label_to_facies_map: dict = field(default_factory=dict)

    _section = "facies"
    _spec = [
        Key("props", Path, required=True),
        Key("path", Path),
    ]

    def _post_load(self, sec: dict, results=None, **_) -> None:
        if not sec.get("path") and results is not None:
            self.path = Path(results) / "setup" / "facies.npz"
        raw_map = sec.get("facies_to_labels", {})
        self.facies_to_labels_map = {
            int(facies): [int(l) for l in labels]
            for facies, labels in raw_map.items()
        }
        self.label_to_facies_map = {
            label: facies
            for facies, labels in self.facies_to_labels_map.items()
            for label in labels
        }
