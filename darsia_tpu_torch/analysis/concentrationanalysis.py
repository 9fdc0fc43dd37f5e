"""Concentration analysis: image -> physical concentration map.

Counterpart of :mod:`darsia_tpu.analysis.concentrationanalysis` for single
frames: baseline difference, scalar reduction, balancing, model conversion
and restoration compose as tensor functions (:meth:`pipeline_fn`), which
:class:`~darsia_tpu_torch.analysis.fusedpipeline.FusedAnalysisPipeline`
inlines.  The cleaning filter learnt from extra baselines is not ported yet.
"""

from __future__ import annotations

from typing import Optional
from warnings import warn

import torch

from ..image.image import Image, ScalarImage

__all__ = ["ConcentrationAnalysis"]


class ConcentrationAnalysis:
    """Determine concentration/saturation maps from image comparison."""

    def __init__(
        self,
        base=None,
        signal_reduction=None,
        balancing=None,
        restoration=None,
        model=None,
        labels=None,
        **kwargs,
    ) -> None:
        self.base: Optional[Image] = None
        if base is not None:
            if isinstance(base, list):
                if len(base) > 1:
                    raise NotImplementedError("the cleaning filter is not ported yet")
                base = base[0]
            if not base.img.dtype.is_floating_point:
                base = base.img_as(torch.float32)
                warn("The baseline image needed to be converted to float.")
            self.base = base.copy()
        self.signal_reduction = signal_reduction
        self.balancing = balancing
        self.model = model
        self.restoration = restoration
        self.labels = labels
        self._diff_option = kwargs.get("diff option", "absolute")
        self.first_restoration_then_model = kwargs.get("restoration -> model", False)

    def _pipeline_stages(self, diff: torch.Tensor) -> torch.Tensor:
        """diff -> concentration."""
        signal = self._reduce_signal(diff)
        balanced = self._balance_signal(signal)
        if self.first_restoration_then_model:
            return self._convert_signal(self._restore_signal(balanced))
        return self._restore_signal(self._convert_signal(balanced))

    def pipeline_fn(self):
        """``pipeline(data, reference=None) -> concentration`` on tensors."""
        has_base = self.base is not None

        def pipeline(data, reference=None):
            diff = self._diff_arrays(data, reference if has_base else None)
            return self._pipeline_stages(diff)

        return pipeline

    def _pipeline_fingerprint(self):
        """Identity of the configuration a built pipeline depends on."""
        return (
            self._diff_option,
            self.first_restoration_then_model,
            None if self.base is None else id(self.base.img),
            id(self.model),
            id(self.balancing),
            id(self.signal_reduction),
            id(self.restoration),
        )

    def __call__(self, img: Image) -> Image:
        """Concentration of a probe image."""
        if not img.img.dtype.is_floating_point:
            img = img.img_as(torch.float32)
            warn("The input for concentration analysis needed to be converted.")
        reference = None if self.base is None else self.base.img
        concentration = self.pipeline_fn()(img.img.to(torch.float32), reference)
        return self._package(concentration, img)

    def _package(self, concentration: torch.Tensor, img: Image) -> Image:
        metadata = img.metadata()
        if concentration.dim() == img.img.dim() - 1:
            return ScalarImage(concentration, **metadata)
        if concentration.shape[-1] == 1:
            return ScalarImage(concentration[..., 0], **metadata)
        return type(img)(concentration, **metadata)

    def _diff_arrays(self, data, reference):
        option = self._diff_option
        if option == "positive":
            diff = (data if reference is None else data - reference).clamp(min=0)
        elif option == "negative":
            diff = (-data if reference is None else reference - data).clamp(min=0)
        elif option == "absolute":
            diff = (data if reference is None else data - reference).abs()
        elif option == "plain":
            diff = data if reference is None else data - reference
        else:
            raise ValueError(f"Diff option {option} not supported")
        return diff

    def _reduce_signal(self, img):
        return img if self.signal_reduction is None else self.signal_reduction(img)

    def _balance_signal(self, img):
        return img if self.balancing is None else self.balancing(img)

    def _restore_signal(self, signal):
        return signal if self.restoration is None else self.restoration(signal)

    def _convert_signal(self, signal):
        return signal if self.model is None else self.model(signal)
