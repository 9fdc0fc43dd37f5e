"""[analysis.segmentation] entry configs (parity: reference
``presets/workflows/config/segmentation.py:21-160``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..mode_resolution import validate_mode_syntax
from .contour_smoother import make_contour_smoother

__all__ = ["SegmentationValueLabelsConfig", "SegmentationConfig"]


@dataclass
class SegmentationValueLabelsConfig:
    show_values: bool = False
    value_color: list = field(default_factory=lambda: [255, 255, 255])
    value_size: float = 0.5
    value_alpha: float = 1.0
    value_density: float = 0.35
    value_min_distance_px: float = 40.0
    value_max_per_contour: int = 3
    value_format: str = "{:.2f}"

    def load(self, sec: dict) -> "SegmentationValueLabelsConfig":
        for key in (
            "show_values",
            "value_color",
            "value_size",
            "value_alpha",
            "value_density",
            "value_min_distance_px",
            "value_max_per_contour",
            "value_format",
        ):
            if key in sec:
                setattr(self, key, sec[key])
        return self


@dataclass
class SegmentationConfig:
    """One segmentation overlay: mode + thresholds + styling."""

    label: Optional[str] = None
    mode: Optional[str] = None
    thresholds: list = field(default_factory=list)
    color: list = field(default_factory=list)
    alpha: list = field(default_factory=list)
    linewidth: int = 2
    values: SegmentationValueLabelsConfig = field(
        default_factory=SegmentationValueLabelsConfig
    )
    contour_smoother: object = None

    def load(
        self, sec: dict, color_embedding_registry=None
    ) -> "SegmentationConfig":
        if "label" not in sec or "mode" not in sec:
            raise KeyError("Segmentation entry requires 'label' and 'mode'.")
        self.label = str(sec["label"])
        self.mode = str(sec["mode"]).strip()
        validate_mode_syntax(
            self.mode, color_embedding_registry, "analysis.segmentation.mode"
        )
        if "thresholds" not in sec or "color" not in sec:
            raise KeyError("Segmentation entry requires 'thresholds' and 'color'.")
        self.thresholds = [float(t) for t in sec["thresholds"]]
        self.color = list(sec["color"])
        self.alpha = list(sec.get("alpha", [1.0] * len(self.thresholds)))
        self.linewidth = int(sec.get("linewidth", 2))
        self.values = SegmentationValueLabelsConfig().load(sec.get("values", {}))
        # The value labels inherit the contour color unless overridden
        # (reference test_segmentation_contour_values.py pins this).
        if "value_color" not in sec.get("values", {}):
            self.values.value_color = list(self.color)
        self.contour_smoother = make_contour_smoother(
            sec.get("contour_smoother", "none"),
            sec.get("contour_smoother_options", {}),
        )
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [analysis.segmentation] in the config file to load segmentation."
        )


