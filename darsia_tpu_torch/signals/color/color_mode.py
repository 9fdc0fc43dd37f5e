"""Colour mode enum.

Counterpart of :mod:`darsia_tpu.signals.color.color_mode`.
"""

from __future__ import annotations

from enum import Enum

__all__ = ["ColorMode"]


class ColorMode(str, Enum):
    """Absolute colours vs colours relative to a baseline."""

    ABSOLUTE = "absolute"
    RELATIVE = "relative"
