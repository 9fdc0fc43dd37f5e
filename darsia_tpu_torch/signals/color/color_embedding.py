"""Colour embeddings: registry-driven 3-D colour -> 1-D signal transforms.

Counterpart of :mod:`darsia_tpu.signals.color.color_embedding` (the basis,
the runtime, the channel, range and path embeddings and their transforms).
The JAX package brings every transform's data to the host; here it stays on
the runtime's device (``ColorEmbeddingRuntime(rig, device=None)``: the card
unless the caller passes ``device="cpu"``), where the image, the rig's
baseline and labels are copied once and the colour space conversions are
:mod:`darsia_tpu_torch.ops.color`'s.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

import torch

from ...image.image import Image, ScalarImage, as_tensor, card_unless
from ...ops.color import convert_trichromatic
from .color_mode import ColorMode
from .label_maps import LabelColorPathMap

__all__ = [
    "ColorEmbeddingBasis",
    "parse_color_embedding_basis",
    "calibration_basis_folder",
    "ColorEmbeddingRuntime",
    "ColorEmbeddingTransform",
    "ColorEmbedding",
    "ColorChannelEmbedding",
    "ColorChannelEmbeddingTransform",
    "ColorPathEmbedding",
    "ColorPathEmbeddingTransform",
    "ColorRangeEmbedding",
    "ColorRangeEmbeddingTransform",
    "to_scalar_image",
    "channel_index",
    "normalized_trichromatic",
]


class ColorEmbeddingBasis(str, Enum):
    """Label space used by colour embedding workflows."""

    LABELS = "labels"
    FACIES = "facies"
    GLOBAL = "global"


def parse_color_embedding_basis(
    value, default: ColorEmbeddingBasis = ColorEmbeddingBasis.FACIES
) -> ColorEmbeddingBasis:
    if value is None:
        return default
    if isinstance(value, ColorEmbeddingBasis):
        return value
    return ColorEmbeddingBasis(str(value).lower().strip())


def calibration_basis_folder(basis) -> str:
    return f"from_{parse_color_embedding_basis(basis).value}"


@dataclass
class ColorEmbeddingRuntime:
    """Runtime context: the rig (any object with ``baseline``, ``labels``,
    ``facies``), the transform cache and the device the transforms compute
    on (None: the card)."""

    rig: object
    cache: dict = field(default_factory=dict)
    device: Optional[object] = None

    def __post_init__(self) -> None:
        self.device = card_unless(self.device, "the colour embeddings")


def _runtime_device(runtime) -> torch.device:
    return card_unless(getattr(runtime, "device", None), "the colour embeddings")


class ColorEmbeddingTransform(ABC):
    """Canonical transform: 3-D colour image -> scalar image."""

    @abstractmethod
    def __call__(self, image: Image) -> ScalarImage: ...


class ColorEmbedding(ABC):
    """Abstract embedding descriptor."""

    embedding_id: str
    mode: ColorMode
    basis: ColorEmbeddingBasis

    @abstractmethod
    def canonical_transform(self, runtime: ColorEmbeddingRuntime) -> ColorEmbeddingTransform: ...

    def to_scalar_image(self, image: Image, runtime: ColorEmbeddingRuntime):
        if self.embedding_id not in runtime.cache:
            runtime.cache[self.embedding_id] = self.canonical_transform(runtime)
        return runtime.cache[self.embedding_id](image)

    def get_labels(self, runtime):
        rig = runtime.rig if isinstance(runtime, ColorEmbeddingRuntime) else runtime
        if self.basis == ColorEmbeddingBasis.GLOBAL:
            base = rig.baseline
            return ScalarImage(
                torch.zeros(
                    tuple(base.num_voxels[:2]), dtype=torch.int64, device=base.img.device
                ),
                **{k: v for k, v in base.metadata().items() if k != "scalar"},
            )
        if self.basis == ColorEmbeddingBasis.FACIES:
            return rig.facies
        if self.basis == ColorEmbeddingBasis.LABELS:
            return rig.labels
        raise ValueError(f"Unsupported color embedding basis {self.basis}.")


def to_scalar_image(template: Image, values) -> ScalarImage:
    metadata = template.metadata()
    metadata.pop("color_space", None)
    return ScalarImage(img=values, **metadata)


def channel_index(color_space: str, channel: str) -> int:
    channel_map = {
        "RGB": {"r": 0, "g": 1, "b": 2},
        "BGR": {"b": 0, "g": 1, "r": 2},
        "HSV": {"h": 0, "s": 1, "v": 2},
        "HLS": {"h": 0, "l": 1, "s": 2},
        "LAB": {"l": 0, "a": 1, "b": 2},
    }
    mapping = channel_map.get(color_space.upper(), {})
    if channel not in mapping:
        raise ValueError(f"Unsupported channel {channel!r} for color space {color_space!r}.")
    return mapping[channel]


def _unit_float(image, device) -> torch.Tensor:
    """An image's data as float32 on ``device``, divided by 255 when its
    maximum exceeds 1.5 (one read of the maximum, as in the JAX package)."""
    data = as_tensor(image.img if hasattr(image, "img") else image, device).to(torch.float32)
    if float(data.max()) > 1.5:
        data = data / 255.0
    return data


def normalized_trichromatic(
    image: Image,
    color_space: str,
    mode: ColorMode,
    baseline: Optional[Image] = None,
    device=None,
):
    """Trichromatic float32 data in the target colour space (optionally
    baseline-relative), on ``device`` (the image's device when None)."""
    device = image.img.device if device is None else torch.device(device)
    data = _unit_float(image, device)
    cs = color_space.upper().strip()
    if mode == ColorMode.RELATIVE:
        if baseline is None:
            raise ValueError("Relative color embedding requires baseline image.")
        data = torch.clamp(data - _unit_float(baseline, device), -1.0, 1.0)
        if cs not in ("RGB", "BGR"):
            raise ValueError("Relative mode only supported in RGB/BGR color spaces.")
        converted = data if cs == "RGB" else data.flip(-1)
    else:
        converted = convert_trichromatic(data, "RGB", cs)
    return converted, cs


@dataclass
class ColorChannelEmbeddingTransform(ColorEmbeddingTransform):
    color_space: str
    channel: str
    mode: ColorMode
    baseline: Optional[Image] = None
    device: Optional[object] = None

    def __call__(self, image: Image) -> ScalarImage:
        trichromatic, cs = normalized_trichromatic(
            image, self.color_space, self.mode, self.baseline, self.device
        )
        idx = channel_index(cs, self.channel)
        return to_scalar_image(image, trichromatic[..., idx].contiguous())


@dataclass
class ColorChannelEmbedding(ColorEmbedding):
    embedding_id: str
    mode: ColorMode
    basis: ColorEmbeddingBasis
    color_space: str = "RGB"
    channel: str = "r"
    calibration_root: Optional[Path] = None
    mask_embedding: object = None

    @property
    def config_file(self) -> Path:
        return Path(self.calibration_root) / "embedding.json"

    def canonical_transform(self, runtime) -> ColorEmbeddingTransform:
        return ColorChannelEmbeddingTransform(
            color_space=self.color_space,
            channel=self.channel,
            mode=self.mode,
            baseline=runtime.rig.baseline if self.mode == ColorMode.RELATIVE else None,
            device=_runtime_device(runtime),
        )


@dataclass
class ColorPathEmbeddingTransform(ColorEmbeddingTransform):
    analysis: object  # ConcentrationAnalysis-like

    def __call__(self, image: Image) -> ScalarImage:
        return self.analysis(image)


class _PathTransform(ColorEmbeddingTransform):
    """Per-label colour-path interpolation of (baseline-relative) unit
    colours on the runtime's device; the baseline is copied there once."""

    def __init__(self, model, baseline, device) -> None:
        self.model = model
        self.device = device
        self.base = None if baseline is None else _unit_float(baseline, device)

    def __call__(self, image: Image) -> ScalarImage:
        data = _unit_float(image, self.device)
        if self.base is not None:
            data = data - self.base
        return to_scalar_image(image, self.model.call_array(data))


@dataclass
class ColorPathEmbedding(ColorEmbedding):
    """Per-label colour-path parametrization embedding."""

    embedding_id: str
    mode: ColorMode
    basis: ColorEmbeddingBasis
    calibration_root: Path
    num_segments: int = 1
    ignore_labels: list = field(default_factory=list)
    resolution: int = 51
    reference_label: int = 0
    threshold_baseline: float = 0.0
    threshold_calibration: float = 0.0
    rois: list = field(default_factory=list)
    ignore_baseline_spectrum: str = "expanded"
    histogram_weighting: str = "threshold"
    calibration_mode: str = "auto"
    baseline_data: object = None
    data: object = None

    @property
    def color_paths_folder(self) -> Path:
        return Path(self.calibration_root) / "color_paths" / calibration_basis_folder(self.basis)

    @property
    def baseline_color_spectrum_folder(self) -> Path:
        return Path(self.calibration_root) / "baseline_color_spectrum"

    @property
    def color_range_file(self) -> Path:
        return Path(self.calibration_root) / "color_range"

    @property
    def color_to_mass_folder(self) -> Path:
        return Path(self.calibration_root) / "color_to_mass" / calibration_basis_folder(self.basis)

    def canonical_transform(self, runtime) -> ColorEmbeddingTransform:
        from ..models.color_path_interpolation import LabelColorPathInterpolation

        device = _runtime_device(runtime)
        labels = self.get_labels(runtime)
        model = LabelColorPathInterpolation(
            color_paths=LabelColorPathMap.load(self.color_paths_folder),
            labels=as_tensor(labels.img, device),
            color_mode=self.mode,
        )
        baseline = runtime.rig.baseline if self.mode == ColorMode.RELATIVE else None
        return _PathTransform(model, baseline, device)


@dataclass
class ColorRangeEmbeddingTransform(ColorEmbeddingTransform):
    color_space: str
    ranges: list
    mode: ColorMode
    baseline: Optional[Image] = None
    restoration: object = None
    device: Optional[object] = None

    def __call__(self, image: Image) -> ScalarImage:
        trichromatic, cs = normalized_trichromatic(
            image, self.color_space, self.mode, self.baseline, self.device
        )
        mask = torch.ones(trichromatic.shape[:2], dtype=torch.bool, device=trichromatic.device)
        for channel, (lower, upper) in enumerate(self.ranges):
            values = trichromatic[..., channel]
            if lower is None and upper is None:
                continue
            if lower is None:
                component = values <= float(upper)
            elif upper is None:
                component = values >= float(lower)
            elif channel == 0 and cs in ("HSV", "HLS") and float(lower) > float(upper):
                # A hue range across 0/360 degrees.
                component = (values >= float(lower)) | (values <= float(upper))
            else:
                component = (values >= float(lower)) & (values <= float(upper))
            mask &= component
        scalar = to_scalar_image(image, mask.to(torch.float32))
        if self.restoration is not None:
            scalar = self.restoration(scalar)
        return scalar


@dataclass
class ColorRangeEmbedding(ColorEmbedding):
    embedding_id: str
    mode: ColorMode
    basis: ColorEmbeddingBasis
    calibration_root: Path
    color_space: str = "HSV"
    ranges: list = field(default_factory=list)
    restoration_config: object = None

    @property
    def config_file(self) -> Path:
        return Path(self.calibration_root) / "embedding.json"

    def canonical_transform(self, runtime) -> ColorEmbeddingTransform:
        if self.basis != ColorEmbeddingBasis.GLOBAL:
            raise NotImplementedError(
                "Color range embedding currently only supports basis='global'."
            )
        return ColorRangeEmbeddingTransform(
            color_space=self.color_space,
            ranges=self.ranges,
            mode=self.mode,
            baseline=runtime.rig.baseline,
            device=_runtime_device(runtime),
        )
