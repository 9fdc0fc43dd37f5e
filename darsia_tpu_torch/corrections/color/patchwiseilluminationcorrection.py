"""Patchwise illumination correction (a grid of patch-mean ratios).

Counterpart of
:mod:`darsia_tpu.corrections.color.patchwiseilluminationcorrection`.  The
patch means are one antialiased linear resize of each baseline (the JAX
package's ``jax.image.resize``, through
:func:`~darsia_tpu_torch.ops.resize._resize_jax`), the division coefficients
are elementwise tensor arithmetic, and correcting an image divides it by the
coefficient grid resized linearly to the image, on the image's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...image.image import as_numpy
from ...ops.resize import _resize_jax
from ...utils.npz import load_npz
from ..base import BaseCorrection

__all__ = ["PatchwiseIlluminationCorrection"]


class PatchwiseIlluminationCorrection(BaseCorrection):
    """Per-patch RGB illumination equalization against baseline images."""

    def __init__(
        self,
        image=None,
        baseline_images: Optional[list] = None,
        nw: int = 1000,
        limit: int = 1450,
        eps: float = 1e-6,
        show_images: bool = False,
    ) -> None:
        self.correction_grid = None  # (nh_full, nw, 3) division coefficients
        self._grid_cache: dict = {}
        if image is None or baseline_images is None:
            return

        self.nw = nw
        self.limit = limit
        self.eps = eps

        img = self._load(image)
        baselines = [self._load(b) for b in baseline_images]

        self.height, self.width = img.shape[:2]
        self.nh = int((self.height - self.limit) * self.nw / self.width)
        self.dh = (self.height - self.limit) / max(self.nh, 1)

        patch_means = [self._patch_means(b, full=False) for b in baselines]
        means = [p.reshape(-1, 3).mean(dim=0) for p in patch_means]
        # Inverse-variance-weighted ratio of the global mean to the local one.
        sum_sq = (torch.stack(patch_means) ** 2).sum(dim=0)
        correction = torch.zeros_like(sum_sq)
        for p, m in zip(patch_means, means):
            weight = p**2 / (sum_sq + self.eps)
            correction = correction + weight * (m / (p + self.eps))
        self.correction_grid = as_numpy(self._extend(1.0 / (correction + self.eps)))

    @staticmethod
    def _load(image) -> torch.Tensor:
        if isinstance(image, (str, Path)):
            from ...image.imread import imread

            image = imread(image)
        data = image.img if hasattr(image, "img") else image
        return data if isinstance(data, torch.Tensor) else torch.from_numpy(np.asarray(data))

    def _patch_means(self, image: torch.Tensor, full: bool) -> torch.Tensor:
        """The patch-mean grid: one antialiased linear resize."""
        arr = image.to(torch.float32)
        if full:
            nh = self.nh + int(self.limit / self.dh) if self.dh > 0 else self.nh
            region = arr
        else:
            nh = self.nh
            region = arr[self.limit :]
        return _resize_jax(region, (nh, self.nw), "linear", antialias=True)

    def _extend(self, corr: torch.Tensor) -> torch.Tensor:
        """Extend the coefficients into the excluded top band (column means)."""
        top_rows = int(self.limit / self.dh) if self.dh > 0 else 0
        if top_rows == 0:
            return corr
        lim = max(int(self.nh / 3), 1)
        avg_top = corr[:lim].mean(dim=0, keepdim=True)
        return torch.cat([avg_top.expand(top_rows, *corr.shape[1:]), corr], dim=0)

    def extract_color_values_patches(self, image, full: bool):
        """The patch means as separate (nh, nw) R, G and B arrays."""
        means = as_numpy(self._patch_means(self._load(image), full))
        return means[..., 0], means[..., 1], means[..., 2]

    def extend_correction_coefficients(self, corr) -> np.ndarray:
        """Extend lower-region coefficients to the full image height."""
        return as_numpy(self._extend(torch.as_tensor(np.asarray(corr, dtype=np.float32))))

    def compute_correction(self, coefficient_list, coefficient_mean_list) -> np.ndarray:
        """Correction coefficients from baseline patch grids."""
        coeffs = [torch.as_tensor(np.asarray(c, dtype=np.float32)) for c in coefficient_list]
        sum_sq = (torch.stack(coeffs) ** 2).sum(dim=0)
        correction = torch.zeros_like(sum_sq)
        for c, m in zip(coeffs, coefficient_mean_list):
            weight = c**2 / (sum_sq + self.eps)
            correction = correction + weight * (m / (c + self.eps))
        return as_numpy(1.0 / (correction + self.eps))

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        if self.correction_grid is None:
            raise ValueError(
                "Correction coefficients are not initialized; provide baseline "
                "images to compute them."
            )
        device = img.device
        grid = self._grid_cache.get(device)
        if grid is None:
            grid = torch.as_tensor(np.asarray(self.correction_grid, np.float32)).to(device)
            self._grid_cache[device] = grid
        # The smooth coefficient grid upsampled to the image, then divided.
        full_grid = _resize_jax(grid, tuple(img.shape[:2]), "linear", antialias=True)
        out = img.to(torch.float32) / full_grid
        if not img.dtype.is_floating_point:
            out = torch.round(out).clamp(0, 255)
        return out.to(img.dtype)

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, class_name=type(self).__name__, correction_grid=self.correction_grid)

    def load(self, path: Path) -> None:
        self.correction_grid = load_npz(path)["correction_grid"]
        self._grid_cache = {}
