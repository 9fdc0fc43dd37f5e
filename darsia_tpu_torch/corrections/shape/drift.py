"""Drift correction: align images to a baseline by a ROI translation.

Counterpart of :mod:`darsia_tpu.corrections.shape.drift`.  The baseline is
kept as the tensor it was given (a numpy baseline as a CPU tensor); the
spectrum of its tapered gray ROI is prepared once per device and window
shape.  One estimator serves both uses: alone, a correction reads its shift
to the host once and warps by it; in a fused chain
(:mod:`darsia_tpu_torch.corrections.fuse`) :meth:`pullback_translation`
returns it as a device tensor that shifts the chain's field, with no host
read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...image.image import as_numpy
from ...ops.fft import phase_correlation_prepared, prepare_phase_reference
from ...utils.box import bounding_box
from ...utils.npz import load_npz
from ..base import BaseCorrection
from .translation import _common_shape, _crop, _shift_to_translation, _to_gray, translate_array

__all__ = ["DriftCorrection"]


class DriftCorrection(BaseCorrection):
    """Correct camera drift by translating images onto a baseline.

    Args:
        base: baseline Image, tensor or array.
        config: ``roi`` (tuple of slices, or corner voxels whose bounding box
            is taken), ``padding`` (relative), ``active``, and
            ``max_displacement`` (voxels; the bound of the estimate in a
            fused chain, default 64).

    """

    def __init__(self, base=None, config: Optional[dict] = None) -> None:
        if base is not None and hasattr(base, "img"):
            if base.space_dim != 2:
                raise NotImplementedError
            base = base.img
        self.base = None if base is None else torch.as_tensor(base)
        self._init_from_config(config or {})

    def _init_from_config(self, config: dict) -> None:
        self.active = config.get("active", True)
        self.relative_padding: float = config.get("padding", 0.0)
        self.max_displacement: float = float(config.get("max_displacement", 64.0))
        roi = config.get("roi")
        if roi is None or isinstance(roi, tuple):
            self.roi = roi
        else:
            self.roi = bounding_box(
                np.asarray(roi),
                padding=round(self.relative_padding * np.min(self.base.shape[:2])),
                max_size=list(self.base.shape[:2]),
            )
        self._references: dict = {}

    def return_config(self) -> dict:
        return {"active": self.active, "padding": self.relative_padding, "roi": self.roi}

    def correct_array(self, img: torch.Tensor, roi: Optional[tuple] = None) -> torch.Tensor:
        if not self.active or self.base is None:
            return img
        roi_src = self.roi if roi is None else roi
        shift = self._shift(img, roi_src)
        if shift is None:
            return img
        translation = _shift_to_translation(
            shift.cpu().numpy().astype(np.float64), roi_src, self.roi
        )
        if not np.isfinite(translation).all():
            return img
        return translate_array(img, translation)

    def _shift(self, img: torch.Tensor, roi: Optional[tuple]) -> Optional[torch.Tensor]:
        """Phase-correlation shift (row, col) of ``img``'s gray window on
        ``roi`` against the baseline's on its ROI, a tensor on ``img``'s
        device; None when the windows are too small."""
        a = _to_gray(_crop(img, roi))
        shape = _common_shape(a, _crop(self.base, self.roi).shape)
        if shape is None:
            return None
        h, w = shape
        key = (img.device, shape)
        reference = self._references.get(key)
        if reference is None:
            # Gray is per pixel: crop first, convert only the window.
            window = _to_gray(_crop(self.base, self.roi).to(img.device))[:h, :w]
            reference = prepare_phase_reference(window[None])
            self._references[key] = reference
        shift, _ = phase_correlation_prepared(reference, a[None, :h, :w], shape)
        return shift[0]

    def pullback_translation(self, img: torch.Tensor) -> torch.Tensor:
        """The per-image pull-back translation ``(drow, dcol)`` (fusion
        protocol): the estimate of :meth:`correct_array`, as a float32
        tensor on ``img``'s device, to add to a downstream field.  Non-finite
        components are 0."""
        shift = None
        if self.active and self.base is not None:
            shift = self._shift(img, self.roi)
        if shift is None:
            return torch.zeros(2, dtype=torch.float32, device=img.device)
        # translate_array's pull-back field is identity - shift.
        t = -shift
        return torch.where(torch.isfinite(t), t, 0.0)

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        roi_serial = None if self.roi is None else [[sl.start, sl.stop] for sl in self.roi]
        config = {
            "active": self.active,
            "padding": self.relative_padding,
            "roi_bounds": roi_serial,
        }
        np.savez(
            path,
            class_name=type(self).__name__,
            base=as_numpy(self.base),
            config=np.array([config], dtype=object),
        )

    def load(self, path) -> None:
        data = load_npz(path)
        self.base = torch.from_numpy(data["base"])
        config = dict(data["config"][0])
        roi_bounds = config.pop("roi_bounds", None)
        if roi_bounds is not None:
            config["roi"] = tuple(slice(b[0], b[1]) for b in roi_bounds)
        self._init_from_config(config)
