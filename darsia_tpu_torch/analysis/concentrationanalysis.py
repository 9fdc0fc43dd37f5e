"""Concentration analysis: image -> physical concentration map.

Counterpart of :mod:`darsia_tpu.analysis.concentrationanalysis`: baseline
difference, scalar reduction, cleaning (a threshold learnt from extra
baselines), balancing, model conversion and restoration compose as tensor
functions (:meth:`pipeline_fn`), which
:class:`~darsia_tpu_torch.analysis.fusedpipeline.FusedAnalysisPipeline`
inlines.  A time series runs through the single-frame pipeline frame by
frame, its output stacked on the time axis.  ``verbosity=2`` draws the
difference and the scalar, clean and balanced signals as the JAX package's
eager path does (per frame of a series, into the same four figures).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional
from warnings import warn

import numpy as np
import torch

from ..image.image import Image, ScalarImage, as_numpy, as_tensor
from ..ops.resize import resize_array
from ..utils.optional import optional_module

__all__ = ["ConcentrationAnalysis", "PriorPosteriorConcentrationAnalysis"]


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
        self._base_collection: list = []
        if base is not None:
            if not isinstance(base, list):
                base = [base]
            if any(not img.img.dtype.is_floating_point for img in base):
                base = [img.img_as(torch.float32) for img in base]
                warn("The baseline image needed to be converted to float.")
            self.base = base[0].copy()
            self._base_collection = base
            if self.base.space_dim != 2:
                raise NotImplementedError("concentration analysis of 2-D images only")
        self.signal_reduction = signal_reduction
        self.balancing = balancing
        self.model = model
        self.restoration = restoration
        self.labels = labels
        self._diff_option = kwargs.get("diff option", "absolute")
        self.first_restoration_then_model = kwargs.get("restoration -> model", False)
        self.verbosity: int = kwargs.get("verbosity", 0)
        self.find_cleaning_filter()
        self.mask = None
        if self.base is not None:
            shape = self.base.img.shape[:2]
            self.mask = torch.ones(shape, dtype=torch.bool, device=self.base.device)

    def update(self, base=None, mask=None) -> None:
        """Update the baseline image and/or the analysis mask."""
        if base is not None:
            if not base.img.dtype.is_floating_point:
                base = base.img_as(torch.float32)
            self.base = base.copy()
        if mask is not None:
            self.mask = mask

    # ------------------------------------------------------ cleaning filter

    def find_cleaning_filter(self, baseline_images: Optional[list] = None) -> None:
        """Learn the structural noise threshold: the pixelwise maximum of the
        reduced difference of each extra baseline (by default those after
        the first given to the constructor) to the baseline."""
        if baseline_images is None and self.base is not None:
            baseline_images = self._base_collection[1:] or None
        self.threshold_cleaning_filter = None
        if baseline_images is not None:
            cleaning = torch.zeros(
                self.base.img.shape[:2], dtype=torch.float32, device=self.base.device
            )
            for img in baseline_images:
                diff = self._subtract_background(img)
                cleaning = torch.maximum(cleaning, self._reduce_signal(diff))
            self.threshold_cleaning_filter = cleaning

    def read_cleaning_filter_from_file(self, path) -> None:
        """Load a cleaning filter from ``.npy``, resized (linear) to the
        baseline's shape where it differs."""
        device = None if self.base is None else self.base.device
        data = as_tensor(np.load(path), device)
        if self.base is not None:
            base_shape = tuple(self.base.img.shape[:2])
            if tuple(data.shape[:2]) != base_shape:
                data = resize_array(data, base_shape, "inter_linear")
        self.threshold_cleaning_filter = data

    def write_cleaning_filter_to_file(self, path_to_filter) -> None:
        """Save the cleaning filter as ``.npy``."""
        path_to_filter = Path(path_to_filter)
        path_to_filter.parent.mkdir(parents=True, exist_ok=True)
        np.save(path_to_filter, self.threshold_cleaning_filter.cpu().numpy())

    # ----------------------------------------------------------------- main

    def _pipeline_stages(self, diff: torch.Tensor) -> torch.Tensor:
        """diff -> concentration."""
        signal = self._reduce_signal(diff)
        self._inspect(signal, "Scalar signal")
        signal = self._clean_signal(signal)
        self._inspect(signal, "Clean signal")
        balanced = self._balance_signal(signal)
        self._inspect(balanced, "Balanced signal")
        if self.first_restoration_then_model:
            return self._convert_signal(self._restore_signal(balanced), diff)
        return self._restore_signal(self._convert_signal(balanced, diff))

    def pipeline_fn(self):
        """``pipeline(data, reference=None) -> concentration`` on tensors."""
        has_base = self.base is not None

        def pipeline(data, reference=None):
            diff = self._diff_arrays(data, reference if has_base else None)
            self._inspect(diff, "Difference")
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
            id(self.threshold_cleaning_filter),
        )

    def __call__(self, img: Image) -> Image:
        """Concentration of a probe image, or of each frame of a series."""
        if not img.img.dtype.is_floating_point:
            img = img.img_as(torch.float32)
            warn("The input for concentration analysis needed to be converted.")
        reference = None if self.base is None else self.base.img
        pipeline = self.pipeline_fn()
        data = img.img.to(torch.float32)
        if img.series:
            # A plain frame loop; each frame contiguous, as a single frame is.
            t = img.space_dim
            frames = [
                pipeline(data.select(t, k).contiguous(), reference)
                for k in range(data.shape[t])
            ]
            concentration = torch.stack(frames, dim=t)
        else:
            concentration = pipeline(data, reference)
        return self._package(concentration, img)

    def _package(self, concentration: torch.Tensor, img: Image) -> Image:
        metadata = img.metadata()
        if concentration.dim() == img.img.dim() - 1:
            return ScalarImage(concentration, **metadata)
        if concentration.shape[-1] == 1:
            return ScalarImage(concentration[..., 0], **metadata)
        return type(img)(concentration, **metadata)

    def _inspect(self, img: torch.Tensor, title: str) -> None:
        """At ``verbosity >= 2``, draw a stage's output in the figure
        ``title`` (one host copy; needs matplotlib).  What is computed does
        not depend on it."""
        if self.verbosity >= 2:
            plt = optional_module("matplotlib.pyplot", "ConcentrationAnalysis(verbosity=2)")
            plt.figure(title)
            plt.imshow(as_numpy(img))

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

    def _subtract_background(self, img: Image) -> torch.Tensor:
        reference = None if self.base is None else self.base.img
        return self._diff_arrays(img.img.to(torch.float32), reference)

    def _reduce_signal(self, img):
        return img if self.signal_reduction is None else self.signal_reduction(img)

    def _clean_signal(self, img):
        if self.threshold_cleaning_filter is None:
            return img
        return (img - self.threshold_cleaning_filter).clamp(min=0)

    def _balance_signal(self, img):
        return img if self.balancing is None else self.balancing(img)

    def _restore_signal(self, signal):
        return signal if self.restoration is None else self.restoration(signal)

    def _convert_signal(self, signal, diff):
        return signal if self.model is None else self.model(signal)


class PriorPosteriorConcentrationAnalysis(ConcentrationAnalysis):
    """Concentration analysis with a posterior review of the prior model.

    ``posterior_model(signal, prior > 0, diff)`` is any callable on numpy
    arrays (a criterion on the prior's connected regions): the three tensors
    are copied to the host for it and its result goes back to their device.
    """

    def __init__(
        self,
        base,
        signal_reduction,
        balancing,
        restoration,
        prior_model,
        posterior_model,
        labels=None,
        **kwargs,
    ) -> None:
        self.posterior_model = posterior_model
        super().__init__(
            base, signal_reduction, balancing, restoration, prior_model, labels, **kwargs
        )

    def _convert_signal(self, signal, diff):
        prior = self.model(signal) if self.model is not None else signal
        posterior = self.posterior_model(
            as_numpy(signal), as_numpy(prior) > 0, as_numpy(diff)
        )
        return as_tensor(np.asarray(posterior), signal.device)
