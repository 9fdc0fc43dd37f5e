"""The label space of the colour embeddings.

Counterpart of the basis part of :mod:`darsia_tpu.signals.color.color_embedding`
(``ColorEmbeddingBasis``, ``parse_color_embedding_basis``,
``calibration_basis_folder``); the embeddings themselves are not ported yet.
"""

from __future__ import annotations

from enum import Enum

__all__ = ["ColorEmbeddingBasis", "calibration_basis_folder", "parse_color_embedding_basis"]


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
