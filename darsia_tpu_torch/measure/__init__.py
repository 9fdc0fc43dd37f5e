"""Measures on images: geometric integration."""

from .integration import (
    ExtrudedGeometry,
    ExtrudedPorousGeometry,
    Geometry,
    PorousGeometry,
    WeightedGeometry,
)

__all__ = [
    "ExtrudedGeometry",
    "ExtrudedPorousGeometry",
    "Geometry",
    "PorousGeometry",
    "WeightedGeometry",
]
