"""[analysis] section with thresholding/mass/volume/fingers/cropping
sub-configs.

Parity: reference ``presets/workflows/config/analysis.py:31-768``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union
from warnings import warn

from ..mode_resolution import validate_mode_syntax
from .contour_smoother import make_contour_smoother
from .fingers import FingersConfig
from .roi import RoiAndLabelConfig, RoiConfig
from .segmentation import SegmentationConfig
from .toml_utils import get_section

__all__ = [
    "SUPPORTED_ANALYSIS_MASS_EXPORT_MODES",
    "AnalysisThresholdingLegendConfig",
    "AnalysisThresholdingConfig",
    "AnalysisSegmentationConfig",
    "AnalysisMassConfig",
    "AnalysisVolumeConfig",
    "AnalysisExpertKnowledgeConfig",
    "AnalysisFingersConfig",
    "AnalysisCroppingConfig",
    "AnalysisConfig",
]

SUPPORTED_ANALYSIS_MASS_EXPORT_MODES = {
    "mass",
    "rescaled_mass",
    "extensive_mass",
    "extensive_rescaled_mass",
    "saturation_g",
    "rescaled_saturation_g",
    "concentration_aq",
    "rescaled_concentration_aq",
}


def _load_roi_dict(sub_sec: dict, key: str, roi_registry, labeled: bool) -> dict:
    """ROI entries: registry-key list or inline tables."""
    raw = sub_sec.get(key)
    cls = RoiAndLabelConfig if labeled else RoiConfig
    if isinstance(raw, list) and roi_registry is not None:
        return (
            roi_registry.resolve_roi_and_labels(raw)
            if labeled
            else roi_registry.resolve_rois(raw)
        )
    if isinstance(raw, dict):
        return {name: cls().load(entry) for name, entry in raw.items()}
    return {}


@dataclass
class AnalysisThresholdingLegendConfig:
    show: bool = True
    font_scale: float = 0.7
    thickness: int = 2
    line_spacing: int = 8
    position: tuple = (20, 20)
    text_color: tuple = (255, 255, 255)
    box_enabled: bool = True
    box_color: tuple = (0, 0, 0)
    box_alpha: float = 0.4
    box_padding: int = 10

    def load(self, sec: dict) -> "AnalysisThresholdingLegendConfig":
        for key in (
            "show",
            "font_scale",
            "thickness",
            "line_spacing",
            "box_enabled",
            "box_alpha",
            "box_padding",
        ):
            if key in sec:
                setattr(self, key, sec[key])
        for key in ("position", "text_color", "box_color"):
            if key in sec:
                setattr(self, key, tuple(sec[key]))
        if not 0 <= self.box_alpha <= 1:
            raise ValueError("legend.box_alpha must be in [0, 1].")
        return self


@dataclass
class AnalysisThresholdingConfig:
    """Layered threshold overlays."""

    @dataclass
    class LayerConfig:
        mode: str = "concentration_aq"
        threshold_min: Optional[float] = None
        threshold_max: Optional[float] = None
        label: str = ""
        fill: tuple = (255, 255, 255)
        stroke: tuple = (0, 0, 0)
        fill_alpha: float = 0.35
        stroke_width: int = 2

        def load(
            self, sec: dict, *, key: str, color_embedding_registry=None
        ) -> "AnalysisThresholdingConfig.LayerConfig":
            self.mode = str(sec["mode"]).strip()
            validate_mode_syntax(
                self.mode,
                color_embedding_registry,
                f"analysis.thresholding.layer.{key}.mode",
            )
            for name in ("threshold_min", "threshold_max"):
                if sec.get(name) is not None:
                    setattr(self, name, float(sec[name]))
            if (
                self.threshold_min is not None
                and self.threshold_max is not None
                and self.threshold_min > self.threshold_max
            ):
                raise ValueError(
                    f"threshold_min > threshold_max in layer {key!r}."
                )
            self.label = str(sec.get("label", key))
            for name in ("fill", "stroke"):
                if name in sec:
                    setattr(self, name, tuple(sec[name]))
            self.fill_alpha = float(sec.get("fill_alpha", self.fill_alpha))
            self.stroke_width = int(sec.get("stroke_width", self.stroke_width))
            return self

    layers: dict = field(default_factory=dict)
    legend: AnalysisThresholdingLegendConfig = field(
        default_factory=AnalysisThresholdingLegendConfig
    )
    folder: Path = field(default_factory=Path)

    def load(
        self, sec: dict, results=None, color_embedding_registry=None
    ) -> "AnalysisThresholdingConfig":
        sub_sec = get_section(sec, "thresholding")
        self.layers = {
            key: self.LayerConfig().load(
                entry, key=key, color_embedding_registry=color_embedding_registry
            )
            for key, entry in sub_sec.get("layer", {}).items()
        }
        self.legend = AnalysisThresholdingLegendConfig().load(
            sub_sec.get("legend", {})
        )
        folder = sub_sec.get("folder")
        self.folder = (
            Path(folder) if folder else Path(results) / "thresholding"
        )
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [analysis.thresholding] in the config file to load thresholding."
        )


@dataclass
class AnalysisSegmentationConfig:
    config: Union[SegmentationConfig, dict] = field(
        default_factory=SegmentationConfig
    )
    folder: Path = field(default_factory=Path)

    def load(
        self, sec: dict, results=None, color_embedding_registry=None
    ) -> "AnalysisSegmentationConfig":
        sub_sec = get_section(sec, "segmentation")
        try:
            self.config = SegmentationConfig().load(
                sub_sec, color_embedding_registry=color_embedding_registry
            )
        except KeyError:
            self.config = {
                key: SegmentationConfig().load(
                    entry, color_embedding_registry=color_embedding_registry
                )
                for key, entry in sub_sec.items()
                if isinstance(entry, dict)
            }
            if not self.config:
                raise KeyError(
                    "Segmentation config must be a single entry or a table of "
                    "entries."
                )
        folder = sub_sec.get("folder")
        self.folder = (
            Path(folder) if folder else Path(results) / "segmentation"
        )
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [analysis.segmentation] in the config file to load segmentation."
        )


@dataclass
class AnalysisMassConfig:
    color: object = None
    roi: dict = field(default_factory=dict)
    roi_and_label: dict = field(default_factory=dict)
    export: Optional[list] = None
    folder: Path = field(default_factory=Path)
    contour_smoother: object = None

    def load(
        self,
        sec: dict,
        results=None,
        roi_registry=None,
        color_embedding_registry=None,
    ) -> "AnalysisMassConfig":
        sub_sec = get_section(sec, "mass")
        color_key = str(sub_sec["color"]).strip()
        if color_embedding_registry is None:
            raise ValueError(
                "analysis.mass.color references [color.*.*], but no "
                "ColorEmbeddingRegistry is available."
            )
        try:
            self.color = color_embedding_registry.resolve(color_key)
        except KeyError as exc:
            raise ValueError(
                f"Unknown analysis.mass.color embedding {color_key!r}."
            ) from exc

        self.roi = _load_roi_dict(sub_sec, "roi", roi_registry, labeled=False)
        self.roi_and_label = _load_roi_dict(
            sub_sec, "roi_and_label", roi_registry, labeled=True
        )

        raw_export = sub_sec.get("export")
        if raw_export is None:
            self.export = None
        else:
            modes = [str(m).strip().lower() for m in raw_export if str(m).strip()]
            invalid = sorted(set(modes) - SUPPORTED_ANALYSIS_MASS_EXPORT_MODES)
            if invalid:
                raise ValueError(
                    f"Unsupported [analysis.mass].export entries: {invalid}. "
                    f"Supported: {sorted(SUPPORTED_ANALYSIS_MASS_EXPORT_MODES)}."
                )
            self.export = list(dict.fromkeys(modes))

        folder = sub_sec.get("folder")
        self.folder = Path(folder) if folder else Path(results) / "mass"
        self.contour_smoother = make_contour_smoother(
            sub_sec.get("contour_smoother", "none"),
            sub_sec.get("contour_smoother_options", {}),
        )
        return self


@dataclass
class AnalysisVolumeConfig:
    roi: dict = field(default_factory=dict)
    roi_and_label: dict = field(default_factory=dict)
    folder: Path = field(default_factory=Path)

    def load(
        self, sec: dict, results=None, roi_registry=None
    ) -> "AnalysisVolumeConfig":
        sub_sec = get_section(sec, "volume")
        self.roi = _load_roi_dict(sub_sec, "roi", roi_registry, labeled=False)
        self.roi_and_label = _load_roi_dict(
            sub_sec, "roi_and_label", roi_registry, labeled=True
        )
        folder = sub_sec.get("folder")
        self.folder = Path(folder) if folder else Path(results) / "volume"
        return self


@dataclass
class AnalysisExpertKnowledgeConfig:
    """ROI constraints on where scalar fields may be non-zero."""

    saturation_g: list = field(default_factory=list)
    concentration_aq: list = field(default_factory=list)

    def load(
        self, sec: dict, roi_registry=None
    ) -> "AnalysisExpertKnowledgeConfig":
        sub_sec = get_section(sec, "expert_knowledge")
        self.saturation_g = list(sub_sec.get("saturation_g", []))
        self.concentration_aq = list(sub_sec.get("concentration_aq", []))
        for name, keys in (
            ("saturation_g", self.saturation_g),
            ("concentration_aq", self.concentration_aq),
        ):
            if not all(isinstance(k, str) for k in keys):
                raise ValueError(
                    f"analysis.expert_knowledge.{name} must be a list[str]."
                )
            if keys:
                if roi_registry is None:
                    raise ValueError(
                        "analysis.expert_knowledge requires a loaded ROI "
                        "registry."
                    )
                roi_registry.resolve_rois(keys)
        return self


@dataclass
class AnalysisFingersConfig:
    config: Union[FingersConfig, dict] = field(default_factory=FingersConfig)
    folder: Path = field(default_factory=Path)
    img_folder: Path = field(default_factory=Path)

    def load(
        self,
        sec: dict,
        results=None,
        roi_registry=None,
        color_embedding_registry=None,
    ) -> "AnalysisFingersConfig":
        sub_sec = get_section(sec, "fingers")
        try:
            self.config = FingersConfig().load(
                sub_sec,
                roi_registry=roi_registry,
                color_embedding_registry=color_embedding_registry,
            )
        except KeyError:
            self.config = {
                key: FingersConfig().load(
                    entry,
                    roi_registry=roi_registry,
                    color_embedding_registry=color_embedding_registry,
                )
                for key, entry in sub_sec.items()
                if isinstance(entry, dict)
            }
            if not self.config:
                raise KeyError(
                    "Fingers config must be a single entry or a table of "
                    "entries."
                )
        folder = sub_sec.get("folder")
        self.folder = Path(folder) if folder else Path(results) / "fingers"
        self.img_folder = self.folder / "img"
        return self

    def error(self):
        """Section-hint raiser (reference config parity)."""
        raise ValueError(
            "Use [analysis.fingers] in the config file to load fingers."
        )


@dataclass
class AnalysisCroppingConfig:
    formats: list = field(default_factory=lambda: ["jpg"])

    def load(self, sec: dict) -> "AnalysisCroppingConfig":
        sub_sec = get_section(sec, "cropping")
        raw = sub_sec.get("formats", ["jpg"])
        self.formats = [str(f).strip().lower() for f in raw]
        invalid = sorted(set(self.formats) - {"jpg", "npz"})
        if invalid:
            raise ValueError(
                f"Unsupported [analysis.cropping].formats: {invalid}."
            )
        return self


@dataclass
class AnalysisConfig:
    data: object = None
    random_traverse: bool = False
    formats: Optional[list] = None
    cropping: Optional[AnalysisCroppingConfig] = None
    segmentation: Optional[AnalysisSegmentationConfig] = None
    mass: Optional[AnalysisMassConfig] = None
    volume: Optional[AnalysisVolumeConfig] = None
    fingers: Optional[AnalysisFingersConfig] = None
    thresholding: Optional[AnalysisThresholdingConfig] = None
    expert_knowledge: AnalysisExpertKnowledgeConfig = field(
        default_factory=AnalysisExpertKnowledgeConfig
    )

    def load(
        self,
        path,
        data=None,
        results=None,
        data_registry=None,
        roi_registry=None,
        format_registry=None,
        color_embedding_registry=None,
    ) -> "AnalysisConfig":
        sec = get_section(path, "analysis")

        try:
            self.data = (
                data_registry.resolve(sec.get("data")) if data_registry else None
            )
        except KeyError:
            warn("No analysis data found. Use [analysis.data].")
            self.data = None

        self.random_traverse = bool(sec.get("random_traverse", False))

        raw_formats = sec.get("formats")
        if raw_formats is None:
            self.formats = None
        else:
            self.formats = [str(f).strip() for f in raw_formats if str(f).strip()]
            if not self.formats:
                raise ValueError("analysis.formats must not be empty.")
            if format_registry is not None:
                available = set(format_registry.keys())
                unsupported = sorted(
                    key
                    for key in self.formats
                    if key not in available
                    and key.lower() not in {"jpg", "png", "npz", "npy", "csv"}
                )
                if unsupported:
                    raise ValueError(
                        f"Unsupported [analysis].formats: {unsupported}."
                    )

        loaders = [
            (
                "cropping",
                lambda: AnalysisCroppingConfig().load(sec),
                AnalysisCroppingConfig,
            ),
            (
                "segmentation",
                lambda: AnalysisSegmentationConfig().load(
                    sec,
                    results,
                    color_embedding_registry=color_embedding_registry,
                ),
                None,
            ),
            (
                "mass",
                lambda: AnalysisMassConfig().load(
                    sec,
                    results,
                    roi_registry=roi_registry,
                    color_embedding_registry=color_embedding_registry,
                ),
                None,
            ),
            (
                "volume",
                lambda: AnalysisVolumeConfig().load(
                    sec, results, roi_registry=roi_registry
                ),
                None,
            ),
            (
                "fingers",
                lambda: AnalysisFingersConfig().load(
                    sec,
                    results,
                    roi_registry=roi_registry,
                    color_embedding_registry=color_embedding_registry,
                ),
                None,
            ),
            (
                "thresholding",
                lambda: AnalysisThresholdingConfig().load(
                    sec,
                    results,
                    color_embedding_registry=color_embedding_registry,
                ),
                None,
            ),
            (
                "expert_knowledge",
                lambda: AnalysisExpertKnowledgeConfig().load(
                    sec, roi_registry=roi_registry
                ),
                AnalysisExpertKnowledgeConfig,
            ),
        ]
        for name, loader, default_cls in loaders:
            try:
                setattr(self, name, loader())
            except KeyError:
                setattr(self, name, default_cls() if default_cls else None)
        return self
