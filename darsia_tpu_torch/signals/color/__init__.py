"""Colour paths, ranges, spectra and embeddings (counterpart of
:mod:`darsia_tpu.signals.color`).

``LabelColorPathMapRegression`` (the calibration workflows' colour-path
regression) is not ported yet: importing it raises an ``ImportError`` that
names ROADMAP.md Queue 1 item 7c.
"""

from .color_embedding import (
    ColorChannelEmbedding,
    ColorChannelEmbeddingTransform,
    ColorEmbedding,
    ColorEmbeddingBasis,
    ColorEmbeddingRuntime,
    ColorEmbeddingTransform,
    ColorPathEmbedding,
    ColorPathEmbeddingTransform,
    ColorRangeEmbedding,
    ColorRangeEmbeddingTransform,
    calibration_basis_folder,
    channel_index,
    normalized_trichromatic,
    parse_color_embedding_basis,
    to_scalar_image,
)
from .color_mode import ColorMode
from .color_path import ColorPath, define_color_path
from .color_range import (
    ColorRange,
    ColorSpectrum,
    DiscreteColorRange,
    color_to_index,
    flatten_index,
    index_to_color,
    unflatten_index,
)
from .label_maps import LabelColorMap, LabelColorPathMap, LabelColorSpectrumMap
from .utils import get_mean_color

__all__ = [
    "ColorChannelEmbedding",
    "ColorChannelEmbeddingTransform",
    "ColorEmbedding",
    "ColorEmbeddingBasis",
    "ColorEmbeddingRuntime",
    "ColorEmbeddingTransform",
    "ColorMode",
    "ColorPath",
    "ColorPathEmbedding",
    "ColorPathEmbeddingTransform",
    "ColorRange",
    "ColorRangeEmbedding",
    "ColorRangeEmbeddingTransform",
    "ColorSpectrum",
    "DiscreteColorRange",
    "LabelColorMap",
    "LabelColorPathMap",
    "LabelColorSpectrumMap",
    "calibration_basis_folder",
    "channel_index",
    "color_to_index",
    "define_color_path",
    "flatten_index",
    "get_mean_color",
    "index_to_color",
    "normalized_trichromatic",
    "parse_color_embedding_basis",
    "to_scalar_image",
    "unflatten_index",
]


def __getattr__(name):
    if name == "LabelColorPathMapRegression":
        raise ImportError(
            "LabelColorPathMapRegression (signals/color/color_path_regression.py) is not "
            "ported yet: it belongs to the calibration workflows, ROADMAP.md Queue 1 item 7c"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
