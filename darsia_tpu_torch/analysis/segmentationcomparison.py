"""Comparison of multiple segmentations: overlaps, unique regions, fractions.

Counterpart of :mod:`darsia_tpu.analysis.segmentationcomparison`.  The
masks, the comparison array, the overlay and the overlaps are computed on
the segmentations' device (numpy inputs go to ``device``, the CUDA card
when None); the comparison array and the overlay stay there as tensors.
``plot`` and ``plot_overlay_segmentation`` draw with matplotlib.
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional

import numpy as np
import torch

from ..image.image import as_numpy, as_tensor
from ..utils.optional import optional_module

__all__ = ["SegmentationComparison"]


class SegmentationComparison:
    """Compare N segmentations (binary or labelled) of the same domain."""

    def __init__(self, number_of_segmented_images: int = 2, device=None, **kwargs) -> None:
        self.device = device
        self.number_of_segmented_images = number_of_segmented_images
        self.component_names = kwargs.get(
            "component_names",
            [f"segmentation {i}" for i in range(number_of_segmented_images)],
        )
        # Distinct overlay colors (RGB), one per non-empty subset.
        base_colors = kwargs.get(
            "colors",
            np.array(
                [
                    [0.8, 0.1, 0.1],
                    [0.1, 0.1, 0.8],
                    [0.1, 0.8, 0.1],
                    [0.8, 0.8, 0.1],
                    [0.8, 0.1, 0.8],
                    [0.1, 0.8, 0.8],
                    [0.5, 0.5, 0.5],
                ]
            ),
        )
        self.colors = np.asarray(base_colors)

    def _binary(self, seg, value=None) -> torch.Tensor:
        arr = as_tensor(seg.img if hasattr(seg, "img") else seg, self.device)
        if value is not None:
            return arr == value
        return arr.to(torch.bool)

    def get_combinations(self) -> list[tuple[int, ...]]:
        """All non-empty subsets of image indices, largest first."""
        indices = range(self.number_of_segmented_images)
        combos: list[tuple[int, ...]] = []
        for size in range(self.number_of_segmented_images, 0, -1):
            combos.extend(combinations(indices, size))
        return combos

    def compare_segmentations_binary_array(self, *segmentations) -> torch.Tensor:
        """Comparison array: for each pixel, which segmentations claim it.

        Returns an int32 tensor where bit i is set when segmentation i is
        active at the pixel.
        """
        masks = [self._binary(s) for s in segmentations]
        shape = masks[0].shape
        assert all(m.shape == shape for m in masks)
        out = torch.zeros(shape, dtype=torch.int32, device=masks[0].device)
        for i, m in enumerate(masks):
            out |= m.to(torch.int32, copy=False).to(out.device) << i
        return out

    def __call__(self, *segmentations, **kwargs) -> torch.Tensor:
        """RGB overlay (float32) visualizing unique and overlapping regions."""
        code = self.compare_segmentations_binary_array(*segmentations)
        combos = self.get_combinations()
        rgb = torch.zeros((*code.shape, 3), dtype=torch.float32, device=code.device)
        for idx, combo in enumerate(combos):
            bits = sum(1 << i for i in combo)
            color = self.colors[idx % len(self.colors)]
            rgb[code == bits] = torch.as_tensor(np.asarray(color, np.float32), device=code.device)
        return rgb

    def overlap(self, seg_a, seg_b) -> float:
        """Jaccard overlap of two binary segmentations."""
        a = self._binary(seg_a)
        b = self._binary(seg_b)
        b = b.to(a.device)
        union = float((a | b).sum())
        if union == 0:
            return 1.0
        return float((a & b).sum()) / union

    def color_fractions(self, comparison_rgb) -> dict:
        """Area fraction per overlay color class (``np.isclose``'s rule in
        float64)."""
        flat = as_tensor(comparison_rgb, self.device).reshape(-1, 3).to(torch.float64)
        active = flat.ne(0).any(dim=1)
        total = max(int(active.sum()), 1)
        fractions = {}
        combos = self.get_combinations()
        for idx, combo in enumerate(combos):
            color = torch.as_tensor(np.asarray(self.colors[idx % len(self.colors)], float), device=flat.device)
            match = torch.isclose(flat, color.expand_as(flat), rtol=1e-5, atol=1e-3).all(dim=1)
            fractions[combo] = float(match.sum()) / total
        return fractions

    def plot(self, comparison_rgb, **kwargs) -> None:
        """Overlay plot with legend."""  # pragma: no cover - visual
        plt = optional_module("matplotlib.pyplot", "SegmentationComparison.plot")
        Patch = optional_module("matplotlib.patches", "SegmentationComparison.plot").Patch

        fig, ax = plt.subplots()
        ax.imshow(as_numpy(comparison_rgb))
        patches = []
        for idx, combo in enumerate(self.get_combinations()):
            names = " & ".join(self.component_names[i] for i in combo)
            patches.append(
                Patch(color=self.colors[idx % len(self.colors)], label=names)
            )
        ax.legend(handles=patches, loc="upper right", fontsize=8)
        plt.show()

    def plot_overlay_segmentation(
        self, comparison_rgb, base_image, opacity: float = 0.6, **kwargs
    ) -> None:  # pragma: no cover - visual
        plt = optional_module("matplotlib.pyplot", "SegmentationComparison.plot_overlay_segmentation")

        comparison_rgb = as_numpy(comparison_rgb)
        base = as_numpy(base_image.img if hasattr(base_image, "img") else base_image).astype(np.float32)
        if base.max() > 1.5:
            base = base / 255.0
        active = comparison_rgb.any(axis=-1, keepdims=True)
        overlay = np.where(
            active, (1 - opacity) * base + opacity * comparison_rgb, base
        )
        plt.imshow(np.clip(overlay, 0, 1))
        plt.show()
