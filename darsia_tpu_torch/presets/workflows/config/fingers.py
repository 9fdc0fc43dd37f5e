"""[analysis.fingers] entry config (parity: reference
``presets/workflows/config/fingers.py:24-120``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..mode_resolution import validate_mode_syntax
from .contour_smoother import make_contour_smoother
from .roi import RoiConfig

__all__ = ["FingersConfig"]


@dataclass
class FingersConfig:
    mode: Optional[str] = None
    threshold: float = 0.0
    roi: Optional[dict] = None
    contour_smoother: object = None
    reduce_to_main_contour: bool = True
    fill_holes: bool = False
    include_skeleton_analysis: bool = False
    include_gradient_based_analysis: bool = False
    gradient_mode: Optional[str] = None

    def load(
        self, sec: dict, roi_registry=None, color_embedding_registry=None
    ) -> "FingersConfig":
        if "mode" not in sec or "threshold" not in sec:
            raise KeyError("Fingers entry requires 'mode' and 'threshold'.")
        self.mode = str(sec["mode"]).strip()
        validate_mode_syntax(
            self.mode, color_embedding_registry, "analysis.fingers.mode"
        )
        self.threshold = float(sec["threshold"])

        roi_raw = sec.get("roi")
        if isinstance(roi_raw, list) and roi_registry is not None:
            self.roi = roi_registry.resolve_rois(roi_raw)
        elif isinstance(roi_raw, dict):
            self.roi = {
                key: RoiConfig().load(entry) for key, entry in roi_raw.items()
            }
        else:
            self.roi = None

        self.contour_smoother = make_contour_smoother(
            sec.get("contour_smoother", "none"),
            sec.get("contour_smoother_options", {}),
        )
        self.reduce_to_main_contour = bool(
            sec.get("reduce_to_main_contour", True)
        )
        self.fill_holes = bool(sec.get("fill_holes", False))
        self.include_skeleton_analysis = bool(
            sec.get("include_skeleton_analysis", False)
        )
        self.include_gradient_based_analysis = bool(
            sec.get("include_gradient_based_analysis", False)
        )
        self.gradient_mode = sec.get("gradient_mode")
        if self.gradient_mode is not None:
            validate_mode_syntax(
                str(self.gradient_mode),
                color_embedding_registry,
                "analysis.fingers.gradient_mode",
            )
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [analysis.fingers] in the config file to load fingers."
        )


