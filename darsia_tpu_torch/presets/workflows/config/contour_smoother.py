"""Contour smoother option configs (parity: reference
``presets/workflows/config/contour_smoother.py``)."""

from __future__ import annotations

from abc import ABC
from dataclasses import dataclass

__all__ = [
    "ContourSmootherConfig",
    "SavitzkyGolaySmootherConfig",
    "make_contour_smoother",
]


@dataclass
class ContourSmootherConfig(ABC):
    """Abstract marker base for contour smoother configs (reference
    ``presets/workflows/config/contour_smoother.py:10-11``)."""


@dataclass
class SavitzkyGolaySmootherConfig(ContourSmootherConfig):
    window_length: int = 21
    polyorder: int = 3

    def load(self, sec: dict) -> "SavitzkyGolaySmootherConfig":
        self.window_length = int(sec.get("window_length", self.window_length))
        self.polyorder = int(sec.get("polyorder", self.polyorder))
        return self


def make_contour_smoother(name: str, options_sec: dict):
    """Instantiate a contour smoother by config name ('none' -> None)."""
    name = str(name).lower().strip()
    if name == "none":
        return None
    from ....analysis import contour_smoother as da

    if name == "savitzky_golay":
        opts = SavitzkyGolaySmootherConfig().load(options_sec)
        return da.SavitzkyGolaySmoother(
            window_length=opts.window_length, polyorder=opts.polyorder
        )
    if name == "gaussian":
        return da.GaussianSmoother(
            window_length=int(options_sec.get("window_length", 11)),
            sigma=options_sec.get("sigma"),
        )
    if name == "moving_average":
        return da.MovingAverageSmoother(
            window=int(options_sec.get("window", 5))
        )
    if name in ("polydp", "poly_dp"):
        return da.PolyDPSmoother(
            epsilon=float(options_sec.get("epsilon", 2.0))
        )
    raise NotImplementedError(f"Unsupported contour smoother type: {name}")
