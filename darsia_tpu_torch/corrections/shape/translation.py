"""Translation estimation and correction.

Counterpart of :mod:`darsia_tpu.corrections.shape.translation`.  The
estimator is FFT phase correlation of two windows (as in the JAX package,
in place of the reference's feature matching); the correction shifts an
image by a fixed translation, and fuses into chains as a static field.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ...image.image import as_tensor
from ...ops.color import rgb_to_gray
from ...ops.fft import phase_correlation
from ...ops.warp import identity_grid, warp_backend
from ...utils.npz import load_npz
from ..base import BaseCorrection

__all__ = ["TranslationCorrection", "TranslationEstimator", "translate_array"]


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 3:
        return rgb_to_gray(img.to(torch.float32))
    return img.to(torch.float32)


def _crop(img: torch.Tensor, roi: Optional[tuple]) -> torch.Tensor:
    return img if roi is None else img[roi[0], roi[1]]


def _common_shape(a: torch.Tensor, b_shape) -> Optional[tuple]:
    """The shape both windows are cut to (phase correlation needs equal
    windows); None when it is too small to correlate."""
    h, w = min(a.shape[0], b_shape[0]), min(a.shape[1], b_shape[1])
    return None if h < 2 or w < 2 else (h, w)


def _shift_to_translation(shift: np.ndarray, roi_src: Optional[tuple], roi_dst: Optional[tuple]):
    """The translation (dx, dy) = (col, row) of a window shift (row, col),
    with the ROI offsets when the src and dst windows differ."""
    offset = np.zeros(2)
    if roi_src is not None and roi_dst is not None:
        offset = np.array(
            [
                (roi_dst[0].start or 0) - (roi_src[0].start or 0),
                (roi_dst[1].start or 0) - (roi_src[1].start or 0),
            ]
        )
    return np.array([shift[1] + offset[1], shift[0] + offset[0]])


def translate_array(img: torch.Tensor, translation_xy, order: int = 1) -> torch.Tensor:
    """Shift an image by (dx, dy) = (col, row): ``output(p) = input(p - t)``."""
    dx, dy = float(translation_xy[0]), float(translation_xy[1])
    coords = identity_grid(tuple(img.shape[:2]), img.device)
    shift = torch.tensor([dy, dx], dtype=torch.float32, device=img.device)
    coords = coords - shift.reshape(2, 1, 1)
    max_disp = int(np.ceil(max(abs(dx), abs(dy)))) + 1
    out = warp_backend(img.to(torch.float32), coords, order=order, max_disp=max_disp)
    if not img.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(img.dtype)


class TranslationEstimator:
    """Estimate the translation aligning two images on a ROI."""

    def __init__(
        self, max_features: int = 200, tol: float = 0.05, keep_percent: float = 0.1
    ) -> None:
        # Kept for the JAX package's signature; phase correlation needs none.
        self.max_features = max_features
        self.tol = tol
        self.keep_percent = keep_percent

    def find_effective_translation(
        self,
        img_src,
        img_dst,
        roi_src: Optional[tuple] = None,
        roi_dst: Optional[tuple] = None,
        plot_matches: bool = False,
    ) -> tuple[np.ndarray, bool]:
        """Translation (dx, dy) = (col, row) aligning ``img_src`` to
        ``img_dst``, and whether it is finite.  Runs on ``img_src``'s device
        (``img_dst`` moves there); the estimate is read to the host once."""
        a = _to_gray(_crop(as_tensor(img_src), roi_src))
        b = _to_gray(_crop(torch.as_tensor(img_dst), roi_dst).to(a.device))
        shape = _common_shape(a, b.shape)
        if shape is None:
            return np.zeros(2), False
        h, w = shape
        shift, _ = phase_correlation(a[:h, :w], b[:h, :w])
        translation = _shift_to_translation(shift.cpu().numpy().astype(np.float64), roi_src, roi_dst)
        return translation, bool(np.isfinite(translation).all())

    def match_roi(
        self,
        img_src,
        img_dst,
        roi_src: Optional[tuple] = None,
        roi_dst: Optional[tuple] = None,
    ):
        """``img_src`` aligned with ``img_dst`` by the translation estimated
        on the ROIs (unchanged if the estimate is not finite)."""
        translation, intact = self.find_effective_translation(
            img_src, img_dst, roi_src, roi_dst
        )
        if not intact:
            return img_src
        return translate_array(as_tensor(img_src), translation)


class TranslationCorrection(BaseCorrection):
    """Apply a fixed translation (x, y) = (col, row), possibly from a file."""

    def __init__(self, translation: Union[str, Path, np.ndarray, list, None] = None) -> None:
        if isinstance(translation, (str, Path)):
            self.load(translation)
        else:
            self.translation = np.asarray(
                np.zeros(2) if translation is None else translation, dtype=float
            )

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        return translate_array(img, self.translation)

    def pullback_field(self, input_shape: tuple, device):
        """Static pull-back field: identity minus the translation."""
        shape = tuple(int(s) for s in input_shape)
        shift = torch.tensor(
            [-float(self.translation[1]), -float(self.translation[0])],
            dtype=torch.float32,
            device=device,
        )
        return identity_grid(shape, device) + shift.reshape(2, 1, 1), {}

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, class_name=type(self).__name__, translation=self.translation)

    def load(self, path) -> None:
        self.translation = load_npz(path)["translation"]
