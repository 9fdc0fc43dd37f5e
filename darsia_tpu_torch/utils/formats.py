"""Data format enumeration (counterpart of :mod:`darsia_tpu.utils.formats`)."""

from __future__ import annotations

from enum import Enum

__all__ = ["Format"]


class Format(Enum):
    """Range format of image data."""

    SCALAR = "scalar"
    VECTOR = "vector"
    TENSOR = "tensor"
