"""Registry of configured color embeddings from [color.*].

Parity: reference
``presets/workflows/config/color_embedding_registry.py:26-333``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ....signals.color import (
    ColorChannelEmbedding,
    ColorEmbeddingBasis,
    ColorMode,
    ColorPathEmbedding,
    ColorRangeEmbedding,
    parse_color_embedding_basis,
)
from .toml_utils import convert_none, get_section, validate_choice

__all__ = [
    "ColorEmbeddingRegistry",
    "parse_color_path_embedding",
    "parse_color_range_embedding",
    "parse_color_channel_embedding",
]


def _parse_mode(value, *, context: str) -> ColorMode:
    try:
        return ColorMode(str(value).lower().strip())
    except Exception as exc:
        raise ValueError(
            f"Invalid {context}.mode {value!r}; use 'relative' or 'absolute'."
        ) from exc


def _calibration_root(cfg: dict, embedding_id: str, color_root) -> Path:
    if "calibration_folder" in cfg:
        return Path(cfg["calibration_folder"])
    return color_root / embedding_id if color_root is not None else Path()


def parse_color_path_embedding(
    cfg: dict,
    embedding_id: str,
    color_root=None,
    data=None,
    data_registry=None,
    roi_registry=None,
) -> ColorPathEmbedding:
    context = f"color.path.{embedding_id}"
    embedding = ColorPathEmbedding(
        embedding_id=embedding_id,
        mode=_parse_mode(cfg.get("mode", "relative"), context=context),
        basis=parse_color_embedding_basis(cfg.get("basis", "labels")),
        calibration_root=_calibration_root(cfg, embedding_id, color_root),
        num_segments=int(cfg.get("num_segments", 1)),
        ignore_labels=list(cfg.get("ignore_labels", [])),
        resolution=int(cfg.get("resolution", 51)),
        threshold_baseline=float(cfg.get("threshold_baseline", 0.0)),
        threshold_calibration=float(cfg.get("threshold_calibration", 0.0)),
        reference_label=int(cfg.get("reference_label", 0)),
        rois=list(cfg.get("rois", [])),
        ignore_baseline_spectrum=validate_choice(
            str(cfg.get("ignore_baseline_spectrum", "expanded")).strip(),
            allowed={"none", "baseline", "expanded"},
            context=context,
            key="ignore_baseline_spectrum",
        ),
        histogram_weighting=validate_choice(
            str(cfg.get("histogram_weighting", "threshold")).strip(),
            allowed={"threshold", "wls", "wls_sqrt", "wls_log"},
            context=context,
            key="histogram_weighting",
        ),
        calibration_mode=validate_choice(
            str(
                cfg.get("mode_calibration", cfg.get("calibration_mode", "auto"))
            ).strip(),
            allowed={"auto", "manual"},
            context=context,
            key="calibration_mode",
        ),
    )
    if data_registry is not None:
        if "baseline" in cfg:
            embedding.baseline_data = data_registry.get(cfg["baseline"])
        if "data" in cfg:
            embedding.data = data_registry.get(cfg["data"])
    if isinstance(cfg.get("roi"), dict) and roi_registry is not None:
        from .roi import RoiAndLabelConfig, RoiConfig

        for key, entry in cfg["roi"].items():
            roi_obj = (
                RoiAndLabelConfig().load(entry)
                if "label" in entry
                else RoiConfig().load(entry)
            )
            roi_registry.register(key, roi_obj)
            if key not in embedding.rois:
                embedding.rois.append(key)
    return embedding


def parse_color_range_embedding(
    cfg: dict,
    embedding_id: str,
    color_root=None,
    data=None,
    data_registry=None,
    roi_registry=None,
) -> ColorRangeEmbedding:
    context = f"color.range.{embedding_id}"
    raw_range = cfg.get("range")
    if not isinstance(raw_range, list) or len(raw_range) != 3:
        raise ValueError(f"{context}.range must be a list of 3 [min,max] bounds.")
    ranges = []
    for i, bound in enumerate(raw_range):
        if not isinstance(bound, list) or len(bound) != 2:
            raise ValueError(f"{context}.range[{i}] must have two entries.")
        low, high = convert_none(bound[0]), convert_none(bound[1])
        ranges.append(
            (
                None if low is None else float(low),
                None if high is None else float(high),
            )
        )
    if "color_space" not in cfg:
        raise ValueError(f"{context}.color_space is required.")
    restoration_config = None
    if "restoration" in cfg:
        if not isinstance(cfg["restoration"], dict):
            raise ValueError(f"{context}.restoration must be a table.")
        from .restoration import RestorationConfig

        restoration_config = RestorationConfig().load(
            {"restoration": cfg["restoration"]}
        )
    return ColorRangeEmbedding(
        embedding_id=embedding_id,
        mode=_parse_mode(cfg.get("mode", "absolute"), context=context),
        basis=parse_color_embedding_basis(cfg.get("basis", "global")),
        calibration_root=_calibration_root(cfg, embedding_id, color_root),
        color_space=str(cfg["color_space"]).upper().strip(),
        ranges=ranges,
        restoration_config=restoration_config,
    )


def parse_color_channel_embedding(
    cfg: dict,
    embedding_id: str,
    color_root=None,
    data=None,
    data_registry=None,
    roi_registry=None,
) -> ColorChannelEmbedding:
    context = f"color.channel.{embedding_id}"
    basis = parse_color_embedding_basis(cfg.get("basis", "global"))
    if basis != ColorEmbeddingBasis.GLOBAL:
        raise NotImplementedError(
            "color.channel.<id> currently only supports basis='global'."
        )
    for key in ("color_space", "channel"):
        if key not in cfg:
            raise ValueError(f"{context}.{key} is required.")
    calibration_root = _calibration_root(cfg, embedding_id, color_root)
    mask_embedding = None
    if "mask" in cfg:
        if not isinstance(cfg["mask"], dict):
            raise ValueError(f"{context}.mask must be a table.")
        mask_embedding = parse_color_range_embedding(
            cfg=cfg["mask"],
            embedding_id=f"{embedding_id}_mask",
            color_root=calibration_root,
            data=data,
            data_registry=data_registry,
            roi_registry=roi_registry,
        )
    return ColorChannelEmbedding(
        embedding_id=embedding_id,
        mode=_parse_mode(cfg.get("mode", "absolute"), context=context),
        basis=basis,
        color_space=str(cfg["color_space"]).upper().strip(),
        channel=str(cfg["channel"]).lower().strip(),
        calibration_root=calibration_root,
        mask_embedding=mask_embedding,
    )


@dataclass
class ColorEmbeddingRegistry:
    """Registry of configured color embeddings."""

    embeddings: dict = field(default_factory=dict)

    def load(
        self,
        path,
        *,
        data=None,
        results=None,
        data_registry=None,
        roi_registry=None,
    ) -> "ColorEmbeddingRegistry":
        sec = get_section(path, "color")
        if not isinstance(sec, dict):
            raise ValueError("[color] must be a table.")
        self.embeddings = {}
        color_root = (
            Path(results) / "calibration" / "color" if results is not None else None
        )
        for kind, parser in (
            ("path", parse_color_path_embedding),
            ("range", parse_color_range_embedding),
            ("channel", parse_color_channel_embedding),
        ):
            kind_sec = sec.get(kind, {})
            if not isinstance(kind_sec, dict):
                continue
            for embedding_id, cfg in kind_sec.items():
                if embedding_id in self.embeddings:
                    raise ValueError(
                        f"Duplicate color embedding id {embedding_id!r}."
                    )
                self.embeddings[embedding_id] = parser(
                    cfg=cfg,
                    embedding_id=embedding_id,
                    color_root=color_root,
                    data=data,
                    data_registry=data_registry,
                    roi_registry=roi_registry,
                )
        return self

    def keys(self) -> list:
        return list(self.embeddings.keys())

    def __contains__(self, key: str) -> bool:
        return key in self.embeddings

    def __getitem__(self, key: str):
        return self.embeddings[key]

    def get(self, key: str, default=None):
        return self.embeddings.get(key, default)

    def resolve(self, key: str):
        if key not in self.embeddings:
            raise KeyError(
                f"Color embedding {key!r} not found. Available: {self.keys()}."
            )
        return self.embeddings[key]
