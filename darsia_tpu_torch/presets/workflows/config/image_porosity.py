"""[image_porosity] section (parity: reference
``presets/workflows/config/image_porosity.py:10-80``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from .toml_utils import Key, SectionConfig

__all__ = ["ImagePorosityConfig"]


@dataclass
class ImagePorosityConfig(SectionConfig):
    mode: Literal["full", "from_image"] = "full"
    tol: float = 0.9
    patches: tuple = (1, 1)
    num_clusters: int = 5
    sample_width: int = 50
    tol_color_distance: float = 0.1
    tol_color_gradient: float = 0.02

    _section = "image_porosity"
    _spec = [
        Key("mode", str, choices={"full", "from_image"}),
        Key("tol", float),
        Key("patches", tuple),
        Key("num_clusters", int),
        Key("sample_width", int),
        Key("tol_color_distance", float),
        Key("tol_color_gradient", float),
    ]
