"""Lightweight run analysis tracking integrated mass over a run.

Counterpart of :mod:`darsia_tpu.presets.workflows.simple_run_analysis`.  The
contour plots draw through
:func:`darsia_tpu_torch.utils.augmented_plotting.plot_contour_on_image`
(matplotlib, imported when called); their masks and highlighted canvases
are computed where the result lies.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...multiphase.mass_analysis import MassAnalysisResults
from ...multiphase.time_series import MultiphaseTimeSeriesAnalysis, MultiphaseTimeSeriesData

__all__ = ["SimpleMultiphaseTimeSeriesData", "SimpleRunAnalysis"]


class SimpleRunAnalysis(MultiphaseTimeSeriesAnalysis):
    """Track the integrated mass over a run, optionally per ROI."""

    def __init__(self, geometry, colors: Optional[dict] = None) -> None:
        super().__init__(geometry)
        self.colors = colors or {}
        self.names: list = []

    def append(self, result: MassAnalysisResults, name: str = "") -> None:
        self.track(result)
        self.names.append(name or getattr(result, "name", ""))

    def integrated_mass(self, result: MassAnalysisResults, roi=None) -> dict:
        """Integrated total, gaseous and aqueous mass (of the ROI's
        subregion of the result when one is given)."""
        if roi is not None and hasattr(result, "subregion"):
            result = result.subregion(roi)
        return {
            "mass": float(self.geometry.integrate(result.mass)),
            "mass_g": float(self.geometry.integrate(result.mass_g)),
            "mass_aq": float(self.geometry.integrate(result.mass_aq)),
        }

    def reset(self) -> None:
        super().reset()
        self.names = []

    # The contour plots: thresholded result fields over the image, in the
    # class's phase colours, at the thresholds of the JAX package.

    def _contours(self, img, masks, colors, alphas, path, thickness):
        from ...utils.augmented_plotting import plot_contour_on_image

        return plot_contour_on_image(
            img=img,
            mask=masks,
            color=colors,
            alpha=alphas,
            thickness=thickness,
            path=path,
            show_plot=False,
            return_image=True,
        )

    def plot_pure_contour_signal(
        self, img, mass_analysis_result, mode: str, threshold: float, path, thickness: int = 5
    ):
        """One white signal contour on a black canvas."""
        field = (
            mass_analysis_result.normalized_signal_aq
            if mode == "aqueous"
            else mass_analysis_result.normalized_signal_g
        )
        black = torch.zeros_like(img.img)
        return self._contours(
            black, [field.img > threshold], [(255, 255, 255)], [1.0], path, thickness
        )

    def plot_simple_contour_signal(self, img, mass_analysis_result, path, thickness: int = 5):
        """The aqueous signal contour at 0.1 and the gaseous one at 0.3."""
        return self._contours(
            img,
            [
                mass_analysis_result.normalized_signal_aq.img > 0.1,
                mass_analysis_result.normalized_signal_g.img > 0.3,
            ],
            [self.color_aq, self.color_g],
            [1.0, 0.8],
            path,
            thickness,
        )

    def plot_contour_saturation_concentration(
        self, img, mass_analysis_result, path, thickness: int = 5
    ):
        """Gas saturation (0.3) and aqueous concentration (0.05) contours."""
        return self._contours(
            img,
            [
                mass_analysis_result.saturation_g.img > 0.3,
                mass_analysis_result.concentration_co2_aq.img > 0.05,
            ],
            [self.color_g, self.color_aq],
            [1.0, 1.0],
            path,
            thickness,
        )

    def plot_contour_saturation(self, img, mass_analysis_result, path, thickness: int = 5):
        """The gas saturation contour only."""
        return self._contours(
            img, [mass_analysis_result.saturation_g.img > 0.3], [self.color_g], [1.0], path, thickness
        )

    def plot_contour_concentration(self, img, mass_analysis_result, path, thickness: int = 5):
        """The aqueous concentration contour only."""
        return self._contours(
            img,
            [mass_analysis_result.concentration_co2_aq.img > 0.05],
            [self.color_aq],
            [1.0],
            path,
            thickness,
        )

    def _highlight(self, background, mask: torch.Tensor, color) -> torch.Tensor:
        """The background clipped to [0, 1] in float64, a colour image's
        masked pixels blended half with ``color`` (RGB, 0-255)."""
        canvas = background.img.to(torch.float64).clamp(0, 1)
        if canvas.dim() == 3:
            tint = 0.5 * torch.tensor(color, dtype=torch.float64, device=canvas.device) / 255.0
            canvas[mask] = 0.5 * canvas[mask] + tint
        return canvas

    def plot_dissolved_CO2(self, background, img, mass_analysis_result, path, thickness: int = 5):
        """Highlight the dissolved (not gaseous) CO2 over the background."""
        mask_co2 = mass_analysis_result.concentration_co2_aq.img > 0.05
        mask_g = mass_analysis_result.saturation_g.img > 0.3
        dissolved = mask_co2 & ~mask_g
        canvas = self._highlight(background, dissolved, self.color_aq)
        return self._contours(canvas, [dissolved], [self.color_aq], [1.0], path, thickness)

    def plot_gas(self, background, img, mass_analysis_result, path, thickness: int = 5):
        """Highlight the gaseous plume over the background."""
        mask_g = mass_analysis_result.saturation_g.img > 0.3
        canvas = self._highlight(background, mask_g, self.color_g)
        return self._contours(canvas, [mask_g], [self.color_g], [1.0], path, thickness)


class SimpleMultiphaseTimeSeriesData(MultiphaseTimeSeriesData):
    """Per-run time series with the image names attached."""

    def __init__(self) -> None:
        super().__init__()
        self.names: list = []

    def append(self, *args, name: str = "", **kwargs) -> None:
        super().append(*args, **kwargs)
        self.names.append(name)

    def reset(self) -> None:
        super().reset()
        self.names = []
