"""ROI config entries (parity: reference
``presets/workflows/config/roi.py:15-100``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ....utils.point import make_coordinate
from .toml_utils import get_key, get_section

__all__ = ["RoiConfig", "MultiRoiConfig", "RoiAndLabelConfig", "RoiAndSubroiConfig"]


@dataclass
class RoiConfig:
    """Physical-coordinate box ROI: two opposite corners."""

    roi: np.ndarray = field(default_factory=lambda: np.zeros((2, 2)))
    name: str = ""

    def load(self, sec: dict) -> "RoiConfig":
        self.roi = make_coordinate(
            np.asarray(
                [
                    get_key(sec, "corner_1", required=True, type_=list),
                    get_key(sec, "corner_2", required=True, type_=list),
                ],
                dtype=float,
            )
        )
        self.name = get_key(sec, "name", default="", required=False, type_=str)
        return self


@dataclass
class MultiRoiConfig:
    roi: dict = field(default_factory=dict)

    def load(self, path) -> "MultiRoiConfig":
        sec = get_section(path, "roi")
        self.roi = {key: RoiConfig().load(entry) for key, entry in sec.items()}
        return self


@dataclass
class RoiAndLabelConfig(RoiConfig):
    """ROI restricted to one segmentation label."""

    label: int = -1

    def load(self, sec: dict) -> "RoiAndLabelConfig":
        super().load(sec)
        self.label = get_key(sec, "label", required=True, type_=int)
        return self


@dataclass
class RoiAndSubroiConfig(RoiConfig):
    """ROI with a nested sub-ROI."""

    subroi_config: RoiConfig = field(default_factory=RoiConfig)

    def load(self, sec: dict) -> "RoiAndSubroiConfig":
        super().load(sec)
        self.subroi_config = RoiConfig().load(sec["subroi"])
        return self
