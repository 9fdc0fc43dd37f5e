"""Time-series tracking of multiphase mass results.

Counterpart of :mod:`darsia_tpu.multiphase.time_series`.  Totals are
``Geometry.integrate``'s float64 sums, one scalar read each.  The plots
draw with matplotlib, imported when called; the contour masks are
thresholded where the result lies and copied as booleans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..image.image import as_numpy
from ..measure.integration import Geometry
from ..utils.npz import load_npz
from ..utils.optional import agg_pyplot, optional_module
from .mass_analysis import MassAnalysisResults

__all__ = ["MultiphaseTimeSeriesAnalysis", "MultiphaseTimeSeriesData", "TimeSeriesData"]

_SERIES = ("times", "mass", "mass_g", "mass_aq", "volume_g")


@dataclass
class TimeSeriesData:
    """Base container of time stamps."""

    times: list = field(default_factory=list)


@dataclass
class MultiphaseTimeSeriesData(TimeSeriesData):
    """Integrated multiphase quantities over time."""

    mass: list = field(default_factory=list)
    mass_g: list = field(default_factory=list)
    mass_aq: list = field(default_factory=list)
    volume_g: list = field(default_factory=list)

    def append(self, time, mass: float, mass_g: float, mass_aq: float, volume_g: float = 0.0):
        self.times.append(time)
        self.mass.append(mass)
        self.mass_g.append(mass_g)
        self.mass_aq.append(mass_aq)
        self.volume_g.append(volume_g)

    def reset(self) -> None:
        for attr in _SERIES:
            getattr(self, attr).clear()

    def clean(self, tol: float = np.inf) -> None:
        """Drop entries whose mass jumps by more than ``tol`` times the
        median jump."""
        if len(self.times) < 3:
            return
        mass = np.asarray(self.mass)
        keep = np.ones(len(mass), dtype=bool)
        jumps = np.abs(np.diff(mass))
        scale = max(np.median(jumps), 1e-12)
        keep[1:] &= jumps < tol * scale
        for attr in _SERIES:
            values = getattr(self, attr)
            setattr(self, attr, [v for v, k in zip(values, keep) if k])

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{attr: np.asarray(getattr(self, attr)) for attr in _SERIES})

    def load(self, path: Path) -> None:
        data = load_npz(Path(path))
        for attr in _SERIES:
            setattr(self, attr, list(data[attr]))

    def plot_mass_over_time(self, path=None, **kwargs):
        plt = optional_module("matplotlib.pyplot", "plot_mass_over_time")

        plt.figure("mass over time")
        plt.plot(self.times, self.mass, label="total")
        plt.plot(self.times, self.mass_g, label="gaseous")
        plt.plot(self.times, self.mass_aq, label="aqueous")
        plt.xlabel("time [h]")
        plt.ylabel("mass [kg]")
        plt.legend()
        if path is not None:
            plt.savefig(path)
            plt.close()
        else:
            plt.show()

    def plot_volume_over_time(self, path=None, **kwargs):
        plt = optional_module("matplotlib.pyplot", "plot_volume_over_time")

        plt.figure("volume over time")
        plt.plot(self.times, self.volume_g, label="gaseous volume")
        plt.xlabel("time [h]")
        plt.ylabel("volume [m^3]")
        plt.legend()
        if path is not None:
            plt.savefig(path)
            plt.close()
        else:
            plt.show()


class MultiphaseTimeSeriesAnalysis:
    """Accumulate integrated mass results over a time series."""

    #: Contour colours of the aqueous and gaseous phases (RGB, 0-255).
    color_aq = (0, 127, 255)
    color_g = (255, 64, 0)

    def __init__(self, geometry: Geometry) -> None:
        self.geometry = geometry
        self.data = MultiphaseTimeSeriesData()

    def reset(self) -> None:
        self.data.reset()

    def track(self, result: MassAnalysisResults) -> None:
        """Integrate one mass-analysis result and append it to the series."""
        mass = float(self.geometry.integrate(result.mass))
        mass_g = float(self.geometry.integrate(result.mass_g))
        mass_aq = float(self.geometry.integrate(result.mass_aq))
        volume_g = (
            float(self.geometry.integrate(result.saturation_g))
            if result.saturation_g is not None
            else 0.0
        )
        self.data.append(result.time, mass, mass_g, mass_aq, volume_g)

    def clean(self, threshold) -> None:
        self.data.clean(threshold)

    def save(self, path: Path) -> None:
        self.data.save(path)

    def load(self, path: Path) -> None:
        self.data.load(path)

    def plot_mass_over_time(self, path=None, **kwargs):
        self.data.plot_mass_over_time(path, **kwargs)

    def plot_volume_over_time(self, path=None, **kwargs):
        self.data.plot_volume_over_time(path, **kwargs)

    def plot_result(self, mass_analysis_result, component: str, path, vmax=None) -> None:
        """Save one component map of a mass-analysis result as PNG."""
        plt = agg_pyplot("plot_result")

        plt.figure()
        plt.imshow(as_numpy(getattr(mass_analysis_result, component).img), vmax=vmax)
        plt.savefig(path)
        plt.close()

    def plot_contour_signal(
        self,
        img,
        mass_analysis_result,
        values_aq: list,
        values_g: list,
        path,
        thickness: int = 5,
    ):
        """Aqueous and gaseous signal contours over the image."""
        from ..utils.augmented_plotting import plot_contour_on_image

        aq = mass_analysis_result.normalized_signal_aq.img
        g = mass_analysis_result.normalized_signal_g.img
        return plot_contour_on_image(
            img=img,
            mask=[aq > value for value in values_aq] + [g > value for value in values_g],
            color=[self.color_aq] * len(values_aq) + [self.color_g] * len(values_g),
            alpha=list(values_aq) + list(values_g),
            thickness=thickness,
            path=path,
            show_plot=False,
            return_image=True,
        )

    def plot_contour_mass(self, img, mass_analysis_result, values: list, path, thickness: int = 5):
        """Mass iso-contours over the image (alpha scales with the level)."""
        from ..utils.augmented_plotting import plot_contour_on_image

        lo, hi = min(values), max(values)
        span = max(hi - lo, 1e-30)
        alphas = [(v - lo) / span * 0.9 + 0.1 for v in values]
        mass = mass_analysis_result.mass.img
        return plot_contour_on_image(
            img=img,
            mask=[mass > value for value in values],
            color=[self.color_g] * len(values),
            alpha=alphas,
            thickness=thickness,
            path=path,
            show_plot=False,
            return_image=True,
        )
