"""Threshold-based segmentation masks + contour overlays.

Counterpart of :mod:`darsia_tpu.presets.workflows.segmentation_contours`.
The threshold is compared where the mode image lives (the rig's device):
``field > threshold`` in the field's dtype, and for the gradient variant the
central / one-sided differences of ``np.gradient`` in float64
(``torch.gradient``).  ``extract_mask`` returns the boolean mask as a
tensor on that device; a step that draws or traces contours copies only the
mask to the host.  ``add_contours`` draws with matplotlib; ``add_contour_values``
stamps the labels with OpenCV (cv2).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...image.image import as_numpy
from ...utils.optional import optional_module
from .mode_resolution import resolve_mode_image

__all__ = [
    "SimpleSegmentation",
    "GradientBasedSegmentation",
    "SegmentationContours",
]


class SimpleSegmentation:
    """One threshold of one analysis mode -> boolean mask."""

    def __init__(self, mode: str, threshold: float) -> None:
        self.mode = mode
        self.threshold = float(threshold)

    def extract_mask(
        self,
        image,
        mass_analysis_result=None,
        color_embedding_registry=None,
        color_embedding_runtime=None,
        scalar_products=None,
    ) -> torch.Tensor:
        field = resolve_mode_image(
            self.mode,
            image,
            mass_analysis_result=mass_analysis_result,
            color_embedding_registry=color_embedding_registry,
            color_embedding_runtime=color_embedding_runtime,
            scalar_products=scalar_products,
        )
        return field.img > self.threshold

    __call__ = extract_mask


class GradientBasedSegmentation(SimpleSegmentation):
    """Threshold on the gradient modulus of the mode image."""

    def extract_mask(self, image, **kwargs) -> torch.Tensor:
        field = resolve_mode_image(self.mode, image, **kwargs)
        arr = field.img.to(torch.float64)
        grad = torch.sqrt(sum(torch.gradient(arr, dim=axis)[0] ** 2 for axis in range(2)))
        return grad > self.threshold


class SegmentationContours:
    """Extract masks for several thresholds and overlay their contours."""

    def __init__(self, config) -> None:
        """``config``: SegmentationConfig (mode, thresholds, color, alpha,
        linewidth, contour_smoother)."""
        self.config = config

    @property
    def requested_modes(self) -> set:
        return {self.config.mode}

    def extract_mask(self, image, threshold: float, **kwargs) -> torch.Tensor:
        return SimpleSegmentation(self.config.mode, threshold).extract_mask(
            image, **kwargs
        )

    def add_contours(
        self, background, masks: list, path=None, show: bool = False
    ):
        """Overlay contours of the masks on the background image; save to
        ``path`` when given.  Returns the matplotlib figure."""
        optional_module("matplotlib", "SegmentationContours.add_contours").use("Agg")
        plt = optional_module("matplotlib.pyplot", "SegmentationContours.add_contours")

        fig, ax = plt.subplots()
        data = as_numpy(background.img if hasattr(background, "img") else background)
        ax.imshow(np.clip(data, 0, 1) if data.ndim == 3 else data)
        colors = self.config.color or [[255, 255, 255]] * len(masks)
        for i, mask in enumerate(masks):
            color = np.asarray(
                colors[i % len(colors)]
                if isinstance(colors[0], (list, tuple))
                else colors,
                dtype=float,
            )
            ax.contour(
                as_numpy(mask).astype(float),
                levels=[0.5],
                colors=[tuple(np.clip(color / 255.0, 0, 1))],
                linewidths=self.config.linewidth,
            )
        ax.set_axis_off()
        if path is not None:
            fig.savefig(path, dpi=200, bbox_inches="tight")
        if not show:
            plt.close(fig)
        return fig

    def add_contour_values(
        self, contour_image, masks: list, thresholds: list, values_config
    ):
        """Stamp threshold value labels next to the contours: one cv2 text
        per contour at its topmost point, duplicates within the configured
        minimum distance suppressed, alpha-blended over the rendered contour
        image."""
        cv2 = optional_module("cv2", "SegmentationContours.add_contour_values")

        base = as_numpy(contour_image.img if hasattr(contour_image, "img") else contour_image)
        if np.issubdtype(base.dtype, np.floating):
            base = (np.clip(base, 0, 1) * 255).astype(np.uint8)
        base = np.ascontiguousarray(base)
        overlay = base.copy()

        alpha = max(0.0, min(1.0, getattr(values_config, "value_alpha", 1.0)))
        font_scale = max(0.1, float(getattr(values_config, "value_size", 0.5)))
        min_distance = max(
            1.0, float(getattr(values_config, "value_min_distance_px", 40.0))
        )
        max_per_contour = max(
            0, int(getattr(values_config, "value_max_per_contour", 1))
        )
        fmt = getattr(values_config, "value_format", "{:.2f}")
        color = list(getattr(values_config, "value_color", None) or [255, 255, 255])
        color = tuple(int(np.clip(c, 0, 255)) for c in (color + [255] * 3)[:3])
        thickness = max(1, int(round(1.2 * font_scale)))

        used: list = []
        for mask, threshold in zip(masks, thresholds):
            binary = as_numpy(mask.img if hasattr(mask, "img") else mask).astype(np.uint8)
            contours, _ = cv2.findContours(
                binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
            )
            try:
                text = fmt.format(float(threshold))
            except (ValueError, IndexError):
                text = str(threshold)
            for contour in contours:
                pts = contour.reshape(-1, 2)
                order = np.argsort(pts[:, 1])  # topmost candidates first
                placed = 0
                for idx in order:
                    if placed >= max_per_contour:
                        break
                    pos = (int(pts[idx, 0]), int(pts[idx, 1]))
                    if any(
                        (pos[0] - u[0]) ** 2 + (pos[1] - u[1]) ** 2
                        < min_distance**2
                        for u in used
                    ):
                        continue
                    cv2.putText(
                        overlay,
                        text,
                        pos,
                        cv2.FONT_HERSHEY_SIMPLEX,
                        font_scale,
                        color,
                        thickness,
                        cv2.LINE_AA,
                    )
                    used.append(pos)
                    placed += 1

        blended = (
            cv2.addWeighted(overlay, alpha, base, 1.0 - alpha, 0.0)
            if alpha < 1.0
            else overlay
        )
        if hasattr(contour_image, "copy") and hasattr(contour_image, "img"):
            out = contour_image.copy()
            out.img = torch.from_numpy(blended).to(contour_image.img.device)
            return out
        return blended

    def __call__(
        self, image, background=None, path=None, show: bool = False, **kwargs
    ):
        masks = [
            self.extract_mask(image, threshold, **kwargs)
            for threshold in self.config.thresholds
        ]
        return self.add_contours(
            background if background is not None else image,
            masks,
            path=path,
            show=show,
        )
