"""Correction-related workflow config dataclasses.

Parity: reference ``src/darsia/presets/workflows/config/corrections.py:12-366``
(per-correction sub-configs + CorrectionsConfig aggregator).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal, Optional
from warnings import warn

__all__ = [
    "TypeCorrectionConfig",
    "ResizeCorrectionConfig",
    "CurvatureCorrectionConfig",
    "DriftCorrectionConfig",
    "ColorCorrectionConfig",
    "IlluminationCorrectionConfig",
    "PatchwiseIlluminationCorrectionConfig",
    "CorrectionsConfig",
]

_CHECKER_POSITIONS = ("upper_left", "upper_right", "lower_left", "lower_right")

_SUPPORTED_COLORSPACES = (
    "rgb",
    "rgb-scalar",
    "lab",
    "lab-scalar",
    "hsl",
    "hsl-scalar",
    "gray",
)


@dataclass
class IlluminationCorrectionConfig:
    """Configuration for illumination correction."""

    labels: list = field(default_factory=list)
    """Labels to use for illumination correction."""
    interpolation: Literal["rbf", "quartic", "illumination"] = "illumination"
    """Interpolation method for the scaling field."""
    colorspace: Literal[
        "rgb", "rgb-scalar", "lab", "lab-scalar", "hsl", "hsl-scalar", "gray"
    ] = "hsl-scalar"
    """Color space for the analysis."""
    width: int = 100
    """Sample patch width."""
    num_samples: int = 30
    """Number of sample patches."""
    seed: int = 42
    """Random seed for patch sampling."""
    sigma: float = 100.0
    """Gaussian smoothing sigma for the correction map."""
    outliers: float = 0.1
    """Fraction of outliers to discard."""
    bounds: tuple = (0.5, 2.0)
    """Bounds for the correction factors."""

    def load(self, sec: dict) -> "IlluminationCorrectionConfig":
        """Populate from a (TOML) dict section."""
        for key in (
            "labels",
            "interpolation",
            "width",
            "num_samples",
            "seed",
            "sigma",
            "outliers",
        ):
            if key in sec:
                setattr(self, key, sec[key])
        if "bounds" in sec:
            self.bounds = tuple(sec["bounds"])
        if "colorspace" in sec:
            if sec["colorspace"] not in _SUPPORTED_COLORSPACES:
                warn(f"Unsupported colorspace {sec['colorspace']}.")
            else:
                self.colorspace = sec["colorspace"]
        return self


@dataclass
class TypeCorrectionConfig:
    """Dtype conversion correction."""

    target_type: str = "float64"

    def load(self, sec: dict) -> "TypeCorrectionConfig":
        self.target_type = str(sec.get("target_type", self.target_type))
        return self


@dataclass
class ResizeCorrectionConfig:
    """Resize correction (scale or explicit target shape)."""

    scale: Optional[float] = None
    target_shape: Optional[tuple] = None

    def load(self, sec: dict) -> "ResizeCorrectionConfig":
        if "scale" in sec:
            self.scale = float(sec["scale"])
        if "target_shape" in sec:
            self.target_shape = tuple(int(v) for v in sec["target_shape"])
        if self.scale is None and self.target_shape is None:
            raise ValueError(
                "[corrections.resize] requires 'scale' or 'target_shape'."
            )
        return self


@dataclass
class CurvatureCorrectionConfig:
    """Curvature correction (raw step config dict or cached file)."""

    config: Optional[dict] = None
    path: Optional[Path] = None

    def load(self, sec: dict) -> "CurvatureCorrectionConfig":
        self.config = sec.get("config")
        self.path = Path(sec["path"]) if "path" in sec else None
        return self


def _checker_position(sec: dict):
    position = sec.get("colorchecker")
    if position is not None and position not in _CHECKER_POSITIONS:
        raise ValueError(
            f"colorchecker must be one of {_CHECKER_POSITIONS}, got {position!r}."
        )
    return position


@dataclass
class DriftCorrectionConfig:
    """Drift correction anchored on a color checker position."""

    colorchecker: Optional[str] = None

    def load(self, sec: dict) -> "DriftCorrectionConfig":
        self.colorchecker = _checker_position(sec)
        return self


@dataclass
class ColorCorrectionConfig:
    """Color correction anchored on a color checker position."""

    colorchecker: Optional[str] = None

    def load(self, sec: dict) -> "ColorCorrectionConfig":
        self.colorchecker = _checker_position(sec)
        return self


@dataclass
class PatchwiseIlluminationCorrectionConfig:
    """Patchwise illumination correction."""

    image_path: Path = field(default_factory=Path)
    baseline_paths: list = field(default_factory=list)
    nw: int = 1000
    limit: int = 1450
    eps: float = 1e-6

    def load(self, sec: dict) -> "PatchwiseIlluminationCorrectionConfig":
        if "image_path" in sec:
            self.image_path = Path(sec["image_path"])
        self.baseline_paths = [Path(p) for p in sec.get("baseline_paths", [])]
        self.nw = int(sec.get("nw", self.nw))
        self.limit = int(sec.get("limit", self.limit))
        self.eps = float(sec.get("eps", self.eps))
        return self


@dataclass
class CorrectionsConfig:
    """[corrections] aggregator (reference corrections.py:280-366)."""

    type: Optional[TypeCorrectionConfig] = None
    resize: Optional[ResizeCorrectionConfig] = None
    drift: Optional[DriftCorrectionConfig] = None
    curvature: Optional[CurvatureCorrectionConfig] = None
    color: Optional[ColorCorrectionConfig] = None
    relative_color: bool = False
    illumination: Optional[IlluminationCorrectionConfig] = None
    patchwise_illumination: Optional[PatchwiseIlluminationCorrectionConfig] = None

    def load(self, path) -> "CorrectionsConfig":
        from .toml_utils import get_section

        sec = get_section(path, "corrections")
        loaders = {
            "type": TypeCorrectionConfig,
            "resize": ResizeCorrectionConfig,
            "drift": DriftCorrectionConfig,
            "curvature": CurvatureCorrectionConfig,
            "color": ColorCorrectionConfig,
            "illumination": IlluminationCorrectionConfig,
            "patchwise_illumination": PatchwiseIlluminationCorrectionConfig,
        }
        for name, cls in loaders.items():
            sub = sec.get(name)
            if sub:
                setattr(self, name, cls().load(sub))
        self.relative_color = bool(sec.get("relative_color", False))
        if sec.get("active_corrections") is not None:
            raise NotImplementedError("active_corrections is not supported.")
        return self
