"""[color_to_mass] section config.

Parity: reference ``presets/workflows/config/color_to_mass.py:26-116`` —
standalone section for the color-to-mass calibration workflow (the repo's
``CalibrationMassConfig`` covers the equivalent ``[calibration.mass]``
sub-section; this config parses the reference's dedicated top-level
section including inline ROI sub-sections injected into a shared
registry).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional
from warnings import warn

from ....signals.color.color_embedding import (
    ColorEmbeddingBasis,
    calibration_basis_folder,
    parse_color_embedding_basis,
)
from .time_data import TimeData
from .toml_utils import get_section, validate_choice

__all__ = ["ColorToMassConfig"]


@dataclass
class ColorToMassConfig:
    """Configuration for color-to-mass calibration."""

    mode: str = "manual"
    fluid: Optional[str] = "co2"
    data: Optional[TimeData] = None
    calibration_folder: Path = field(default_factory=Path)
    basis: ColorEmbeddingBasis = ColorEmbeddingBasis.LABELS
    threshold: float = 0.2
    rois: list = field(default_factory=list)

    def load(
        self,
        path,
        data=None,
        results=None,
        data_registry=None,
        roi_registry=None,
    ) -> "ColorToMassConfig":
        """Load from the ``[color_to_mass]`` section of a TOML file.

        ``data`` is accepted for signature parity (the data folder; path
        resolution rides the registries here).  ``results`` anchors the
        default calibration folder.  ``data = "key"`` references resolve
        through ``data_registry``; inline ``[color_to_mass.roi.*]``
        sub-sections are registered into ``roi_registry``.
        """
        sec = get_section(path, "color_to_mass")

        self.mode = validate_choice(
            str(sec.get("mode", "manual")).strip(),
            allowed={"manual", "auto", "automatic"},
            context="color_to_mass",
            key="mode",
        )
        self.fluid = str(sec.get("fluid", "co2")).strip()
        self.basis = parse_color_embedding_basis(
            sec.get("basis", ColorEmbeddingBasis.LABELS.value)
        )
        self.threshold = float(sec.get("threshold", 0.2))
        self.rois = list(sec.get("rois", []))

        if "data" in sec:
            raw = sec["data"]
            if data_registry is not None and isinstance(raw, str):
                self.data = data_registry.resolve(raw)
            elif data_registry is not None and isinstance(raw, list):
                merged = TimeData()
                for key in raw:
                    resolved = data_registry.resolve(key)
                    merged.image_times.extend(resolved.image_times)
                    merged.image_intervals.update(resolved.image_intervals)
                    merged.image_windows.update(resolved.image_windows)
                    merged.image_paths.extend(resolved.image_paths)
                self.data = merged
            elif isinstance(raw, dict):
                self.data = TimeData().load(raw)
            else:
                self.data = None
        else:
            warn("No data found. Use [color_to_mass.data].")
            self.data = None

        if "calibration_folder" in sec:
            self.calibration_folder = Path(sec["calibration_folder"])
        else:
            assert results is not None, (
                "color_to_mass requires a results folder when no "
                "calibration_folder is configured."
            )
            self.calibration_folder = (
                Path(results)
                / "calibration"
                / "color_to_mass"
                / calibration_basis_folder(self.basis)
            )

        # Inline ROI sub-sections, keyed into the shared registry.
        if isinstance(sec.get("roi"), dict) and roi_registry is not None:
            from .roi import RoiAndLabelConfig, RoiConfig

            for key, entry in sec["roi"].items():
                roi_obj = (
                    RoiAndLabelConfig() if "label" in entry else RoiConfig()
                ).load(entry)
                roi_registry.register(key, roi_obj)
                if key not in self.rois:
                    self.rois.append(key)

        return self
