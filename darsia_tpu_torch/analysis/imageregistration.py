"""Diffeomorphic image registration (single- and multiscale) and its facade.

Counterpart of :mod:`darsia_tpu.analysis.imageregistration`.
Every path warps through :func:`~darsia_tpu_torch.ops.warp.warp_backend`,
so on CUDA each warp is a pair of K1 launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import upsample_linear
from ..restoration.resize import Resize
from .translationanalysis import TranslationAnalysis, warp_image

__all__ = [
    "DiffeomorphicImageRegistration",
    "ImageRegistration",
    "MultiscaleDiffeomorphicImageRegistration",
]


class DiffeomorphicImageRegistration:
    """Deformation detection between images (wraps TranslationAnalysis).

    ``fused=True`` (default) registers through the fused lane; a call with a
    ``mask`` takes the flexible lane, which the fused lane does not model.
    """

    def __init__(self, img_dst, **kwargs) -> None:
        self.N_patches = kwargs.get("N_patches", [1, 1])
        self.rel_overlap = kwargs.get("rel_overlap", 0.0)
        self.fused = kwargs.get("fused", True)
        self.max_disp = int(kwargs.get("max_disp", 120))
        self.translation_analysis = TranslationAnalysis(
            img_dst,
            N_patches=self.N_patches,
            rel_overlap=self.rel_overlap,
            mask=kwargs.get("mask_dst"),
            quality_tol=kwargs.get("quality_tol", 0.03),
        )

    def update_dst(self, img_dst) -> None:
        self.translation_analysis.update_base(img_dst)

    def deduct(self, other: "DiffeomorphicImageRegistration") -> None:
        ta = self.translation_analysis
        ta.deduct_translation_analysis(other.translation_analysis)

    def add(self, other: "DiffeomorphicImageRegistration") -> None:
        ta = self.translation_analysis
        ta.add_translation_analysis(other.translation_analysis)

    def __call__(self, img, mask=None, return_transformed_dst: bool = False):
        ta = self.translation_analysis
        if self.fused and mask is None:
            ta.load_image(img, mask=mask)
            transformed = ta.fused_align(img, max_disp=self.max_disp)
        else:
            transformed = ta(img, mask=mask)
        if return_transformed_dst:
            return transformed, ta.translate_image(ta.base, reverse=False)
        return transformed

    def call_with_output(
        self,
        img,
        plot_patch_translation: bool = False,
        return_patch_translation: bool = False,
        mask=None,
    ):
        """Register; with ``plot_patch_translation`` draw :meth:`plot`; with
        ``return_patch_translation`` also return the (N0, N1, 2) metric
        displacement at the patch centres."""
        transformed = self(img, mask=mask)
        if plot_patch_translation:
            self.plot()
        if return_patch_translation:
            ta = self.translation_analysis
            return transformed, ta.return_patch_translation(reverse=True)
        return transformed

    def plot(self, scaling: float = 1.0, mask=None) -> None:
        """Quiver plot of the registered deformation over the base
        (:meth:`TranslationAnalysis.plot_translation`; needs matplotlib)."""
        self.translation_analysis.plot_translation(reverse=False, scaling=scaling, mask=mask)

    def displacement(self) -> torch.Tensor:
        """Dense (2, H, W) displacement in voxel units, on the base's device."""
        ta = self.translation_analysis
        return ta.displacement_field(tuple(ta.base.num_voxels[:2]))

    def apply(self, img, reverse: bool = True):
        """Apply the registered deformation to another image."""
        return self.translation_analysis.translate_image(img, reverse=reverse)

    def evaluate(self, points, units: str = "metric") -> np.ndarray:
        """(M, 2) displacement at points.

        ``units="metric"``: points are Cartesian (x, y) coordinates and the
        displacements metric (y against rows); ``units="pixel"``: points and
        displacements are (x, y) pixel values.  The interpolant lives in
        pixel space; metric probes are converted through the base's
        coordinate system first.
        """
        pts = np.atleast_2d(np.asarray(points, dtype=float))
        ta = self.translation_analysis
        if units == "metric":
            voxels = np.atleast_2d(ta.base.coordinatesystem.voxel(pts)).astype(float)
            pts = np.stack([voxels[:, 1], voxels[:, 0]], axis=1)
        disp = np.asarray(ta.translation(pts)).T
        if units == "metric":
            vs = ta.base.voxel_size
            disp = np.stack([disp[:, 0] * vs[1], -disp[:, 1] * vs[0]], axis=1)
        return disp


class MultiscaleDiffeomorphicImageRegistration(DiffeomorphicImageRegistration):
    """Coarse-to-fine registration accumulating the displacement over levels.

    Level k (coarsest first) resizes the base and the running image by
    2^-(k-1), estimates with the flexible lane, upscales the field to full
    resolution (divided by the factor) and adds it to the total; the
    original image is then warped once by the total.
    """

    def __init__(self, img_dst, **kwargs) -> None:
        super().__init__(img_dst, **kwargs)
        self.num_levels = kwargs.get("num_levels", 3)
        self.kwargs = kwargs
        self.img_dst = img_dst
        self._total_field = None

    def __call__(self, img, mask=None, return_transformed_dst: bool = False):
        current = img
        total = None
        base_full = self.img_dst
        H, W = base_full.num_voxels[:2]
        for level in range(self.num_levels, 0, -1):
            factor = 0.5 ** (level - 1)
            if factor < 1.0:
                resizer = Resize(fx=factor, fy=factor, interpolation="inter_area")
                dst_level, img_level = resizer(base_full), resizer(current)
            else:
                dst_level, img_level = base_full, current
            analysis = TranslationAnalysis(
                dst_level,
                N_patches=self.N_patches,
                rel_overlap=self.rel_overlap,
                quality_tol=self.kwargs.get("quality_tol", 0.03),
            )
            analysis.load_image(img_level)
            analysis.find_translation()
            field = analysis.displacement_field(tuple(dst_level.num_voxels[:2]))
            if factor < 1.0:
                # Values scale with the grid.
                field = upsample_linear(field.permute(1, 2, 0), (H, W)).permute(2, 0, 1)
                field = field / factor
            total = field if total is None else total + field
            current = warp_image(img, total, -1.0, round_integers=False)
        self._total_field = total
        self.translation_analysis = analysis  # the last (full-resolution) level
        if return_transformed_dst:
            return current, base_full
        return current

    def displacement(self) -> torch.Tensor:
        """The accumulated (2, H, W) displacement in voxel units (before any
        call: the single-scale analysis' field, zero)."""
        if self._total_field is None:
            return super().displacement()
        return self._total_field

    def apply(self, img, reverse: bool = True):
        """Warp another image by the accumulated displacement."""
        if self._total_field is None:
            raise RuntimeError("Call registration first.")
        return warp_image(
            img, self._total_field, -1.0 if reverse else 1.0, round_integers=False
        )


class ImageRegistration:
    """Facade for (multiscale) diffeomorphic image registration: multiscale
    when ``num_levels > 1`` (or ``multiscale=True``)."""

    def __init__(self, img_dst, **kwargs) -> None:
        if kwargs.get("multiscale", kwargs.get("num_levels", 1) > 1):
            self._engine = MultiscaleDiffeomorphicImageRegistration(img_dst, **kwargs)
        else:
            self._engine = DiffeomorphicImageRegistration(img_dst, **kwargs)
        self.img_dst = img_dst

    def __call__(self, img, mask=None):
        """Register ``img`` onto the destination image."""
        return self._engine(img, mask=mask)

    def apply(self, img, reverse: bool = True):
        """Warp another image by the registered deformation."""
        return self._engine.apply(img, reverse=reverse)

    def evaluate(self, points, units: str = "metric") -> np.ndarray:
        """Sample the displacement at points."""
        return self._engine.evaluate(points, units=units)

    def plot(self, scaling: float = 1.0, mask=None) -> None:
        """Quiver plot of the registered deformation (needs matplotlib)."""
        self._engine.plot(scaling=scaling, mask=mask)

    def displacement(self) -> torch.Tensor:
        """Dense (2, H, W) displacement in voxel units."""
        return self._engine.displacement()
