"""Per-label containers of color paths / spectra / colors.

Counterpart of :mod:`darsia_tpu.signals.color.label_maps`: the same files
are written and read (a folder of ``label_<i>.json`` paths, of
``label_<i>.npz`` spectra, one json of colours).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .color_path import ColorPath
from .color_range import ColorSpectrum

__all__ = ["LabelColorMap", "LabelColorPathMap", "LabelColorSpectrumMap"]


class LabelColorMap(dict):
    """label -> representative color."""

    def labels(self) -> list:
        """Label keys (reference label_color_map.py:20-21)."""
        return list(self.keys())

    def mean(self) -> np.ndarray:
        """Mean of the stored colors (reference label_color_map.py:17-18)."""
        return np.mean(np.array(list(self.values())), axis=0)

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps({str(k): np.asarray(v).tolist() for k, v in self.items()})
        )

    @classmethod
    def load(cls, path: Path) -> "LabelColorMap":
        data = json.loads(Path(path).with_suffix(".json").read_text())
        return cls({int(k): np.asarray(v) for k, v in data.items()})


class LabelColorPathMap(dict):
    """label -> ColorPath, persisted as a folder of json paths."""

    def save(self, folder: Path) -> None:
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        for label, color_path in self.items():
            color_path.save(folder / f"label_{label}.json")

    @classmethod
    def load(cls, folder: Path) -> "LabelColorPathMap":
        folder = Path(folder)
        out = cls()
        for file in sorted(folder.glob("label_*.json")):
            label = int(file.stem.split("_")[1])
            out[label] = ColorPath.load(file)
        return out

    @classmethod
    def refine(
        cls,
        color_path_map: "LabelColorPathMap",
        num_segments: int,
        distance_to_left=None,
        distance_to_right=None,
        mode: str = "relative",
    ) -> "LabelColorPathMap":
        """Per-label :meth:`ColorPath.refine`
        (reference label_color_path_map.py:86-115)."""
        return cls(
            {
                label: color_path.refine(
                    num_segments=num_segments,
                    distance_to_left=distance_to_left,
                    distance_to_right=distance_to_right,
                    mode=mode,
                )
                for label, color_path in color_path_map.items()
            }
        )

    def show_cmaps(self) -> None:  # pragma: no cover - visual
        """Show each label's colormap (reference
        label_color_path_map.py:37-40)."""
        for _, color_path in self.items():
            color_path.show_cmap()

    def show_paths(self) -> None:  # pragma: no cover - visual
        """Show each label's path in RGB space (reference
        label_color_path_map.py:42-45)."""
        for _, color_path in self.items():
            color_path.show_path()


class LabelColorSpectrumMap(dict):
    """label -> ColorSpectrum, persisted as a folder of npz spectra."""

    def save(self, folder: Path) -> None:
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        for label, spectrum in self.items():
            spectrum.save(folder / f"label_{label}.npz")

    @classmethod
    def load(cls, folder: Path) -> "LabelColorSpectrumMap":
        folder = Path(folder)
        out = cls()
        for file in sorted(folder.glob("label_*.npz")):
            label = int(file.stem.split("_")[1])
            out[label] = ColorSpectrum.load(file)
        return out
