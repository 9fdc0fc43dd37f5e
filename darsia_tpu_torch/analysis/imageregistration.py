"""Single-scale diffeomorphic image registration (fused lane) and facade.

Counterpart of :mod:`darsia_tpu.analysis.imageregistration`; multiscale
registration is not ported yet.
"""

from __future__ import annotations

from .translationanalysis import TranslationAnalysis

__all__ = ["DiffeomorphicImageRegistration", "ImageRegistration"]


class DiffeomorphicImageRegistration:
    """Deformation detection between images (wraps TranslationAnalysis)."""

    def __init__(self, img_dst, **kwargs) -> None:
        self.N_patches = kwargs.get("N_patches", [1, 1])
        self.rel_overlap = kwargs.get("rel_overlap", 0.0)
        self.max_disp = int(kwargs.get("max_disp", 120))
        self.translation_analysis = TranslationAnalysis(
            img_dst,
            N_patches=self.N_patches,
            rel_overlap=self.rel_overlap,
            quality_tol=kwargs.get("quality_tol", 0.03),
        )

    def __call__(self, img):
        return self.translation_analysis.fused_align(img, max_disp=self.max_disp)


class ImageRegistration:
    """Facade for (single-scale) diffeomorphic image registration."""

    def __init__(self, img_dst, **kwargs) -> None:
        if kwargs.get("multiscale", kwargs.get("num_levels", 1) > 1):
            raise NotImplementedError("multiscale registration is not ported yet")
        self._engine = DiffeomorphicImageRegistration(img_dst, **kwargs)
        self.img_dst = img_dst

    def __call__(self, img):
        """Register ``img`` onto the destination image."""
        return self._engine(img)
