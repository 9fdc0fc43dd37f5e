"""Contour smoothing strategies.

Counterpart of :mod:`darsia_tpu.analysis.contour_smoother` (the same numpy
smoothers; ``PolyDPSmoother`` needs OpenCV, imported when it is called).
A contour is an OpenCV-style (N, 1, 2) integer array; the JAX package's
``Contour`` alias of ``np.ndarray`` is not repeated here.
Parity: reference
``src/darsia/single_image_analysis/contour_smoother.py:18-343``.
"""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "ContourSmoother",
    "ContourSmootherSequence",
    "PolyDPSmoother",
    "MovingAverageSmoother",
    "GaussianSmoother",
    "SavitzkyGolaySmoother",
]


def _as_xy(contour) -> np.ndarray:
    return np.asarray(contour).reshape(-1, 2).astype(float)


def _as_contour(xy: np.ndarray, dtype=np.int32) -> np.ndarray:
    return np.round(xy).astype(dtype).reshape(-1, 1, 2)


def _is_closed(xy: np.ndarray, tol: float = 1e-9) -> bool:
    return len(xy) > 2 and np.linalg.norm(xy[0] - xy[-1]) < tol


def _wrap_pad(arr: np.ndarray, pad: int) -> np.ndarray:
    return np.concatenate([arr[-pad:], arr, arr[:pad]], axis=0)


class ContourSmoother(ABC):
    """Smooth cv2-style contours ((N, 1, 2) int arrays)."""

    def __call__(self, contour):
        xy = _as_xy(contour)
        if len(xy) < 3:
            return contour
        smoothed = self._smooth_xy(xy)
        return _as_contour(smoothed)

    @abstractmethod
    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:
        ...


class ContourSmootherSequence(ContourSmoother):
    """Sequential composition of smoothers."""

    def __init__(self, steps: Sequence[ContourSmoother]) -> None:
        self.steps = list(steps)

    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:
        for step in self.steps:
            xy = _as_xy(step(_as_contour(xy)))
        return xy


class PolyDPSmoother(ContourSmoother):
    """Douglas-Peucker polygon simplification (cv2.approxPolyDP).

    Parity: reference ``contour_smoother.py:125-150`` — ``epsilon`` is a
    ratio of the arc length by default (``use_ratio=True``) or absolute
    pixels otherwise.
    """

    def __init__(
        self,
        epsilon: float = 0.01,
        closed: bool = True,
        use_ratio: bool = True,
        relative: Optional[bool] = None,
    ) -> None:
        self.epsilon = float(epsilon)
        self.closed = bool(closed)
        self.use_ratio = bool(use_ratio if relative is None else relative)

    def __call__(self, contour):
        try:
            cv2 = importlib.import_module("cv2")
        except ImportError as err:
            raise ImportError("PolyDPSmoother needs OpenCV (cv2.approxPolyDP)") from err
        contour = np.asarray(contour, dtype=np.int32).reshape(-1, 1, 2)
        eps = self.epsilon
        if self.use_ratio:
            eps = self.epsilon * cv2.arcLength(
                contour.astype(np.float32), self.closed
            )
        return cv2.approxPolyDP(contour, eps, closed=self.closed)

    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:  # pragma: no cover
        return _as_xy(self(_as_contour(xy)))


class MovingAverageSmoother(ContourSmoother):
    """Circular moving average along the contour."""

    def __init__(self, window: int = 9, closed: Optional[bool] = None) -> None:
        self.window = max(int(window) | 1, 3)
        self.closed = closed

    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:
        pad = self.window // 2
        padded = _wrap_pad(xy, pad)
        kernel = np.ones(self.window) / self.window
        out = np.stack(
            [np.convolve(padded[:, i], kernel, mode="valid") for i in range(2)],
            axis=1,
        )
        return out


class GaussianSmoother(ContourSmoother):
    """Circular Gaussian smoothing along the contour."""

    def __init__(
        self,
        window_length: int = 11,
        sigma: Optional[float] = None,
        closed: Optional[bool] = None,
    ) -> None:
        self.window_length = max(int(window_length) | 1, 3)
        self.sigma = sigma if sigma is not None else self.window_length / 4.0

    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:
        wl = min(self.window_length, len(xy) - (len(xy) + 1) % 2)
        x = np.arange(wl) - wl // 2
        kernel = np.exp(-(x**2) / (2 * self.sigma**2))
        kernel /= kernel.sum()
        pad = wl // 2
        padded = _wrap_pad(xy, pad)
        return np.stack(
            [np.convolve(padded[:, i], kernel, mode="valid") for i in range(2)],
            axis=1,
        )


class SavitzkyGolaySmoother(ContourSmoother):
    """Savitzky-Golay filtering along the contour (scipy.signal)."""

    def __init__(self, window_length: int = 11, polyorder: int = 3) -> None:
        self.window_length = max(int(window_length) | 1, 5)
        self.polyorder = polyorder

    def _smooth_xy(self, xy: np.ndarray) -> np.ndarray:
        from scipy.signal import savgol_filter

        wl = min(self.window_length, len(xy) - (len(xy) + 1) % 2)
        if wl <= self.polyorder + 1:
            return xy
        return np.stack(
            [
                savgol_filter(xy[:, i], wl, self.polyorder, mode="wrap")
                for i in range(2)
            ],
            axis=1,
        )
