"""Dynamic (histogram-based) threshold models.

Counterpart of :mod:`darsia_tpu.signals.models.dynamicthresholdmodel`.  A
threshold there is an edge of ``np.histogram``'s 256 uniform bins, so the
counts must be numpy's exactly: :func:`label_histograms` reproduces numpy's
uniform-bin path in float64 on the signal's device, for every label in one
``bincount``, and only the (labels, bins) counts and the edges meet the
host, where Otsu's split and the two-peak valley run as in the JAX package.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from .staticthresholdmodel import StaticThresholdModel

__all__ = [
    "DynamicThresholdModel",
    "GlobalMinTwoPeakHistogrammAnalysis",
    "HistogrammBasedThresholding",
    "OtsuTwoPeakHistogrammAnalysis",
    "StandardOtsu",
    "TwoPeakHistogrammAnalysis",
    "label_histograms",
    "otsu_threshold",
]


def label_histograms(values: torch.Tensor, groups: torch.Tensor, num_groups: int, bins: int = 256):
    """``np.histogram(values[groups == g], bins)`` for every group g at once.

    Args:
        values: float tensor, any shape.
        groups: int64 tensor of the same shape, the group of each value in
            [0, num_groups), or -1 for a value that belongs to none.
        num_groups: number of groups.
        bins: number of uniform bins.

    Returns:
        (counts, edges, sizes) on the host: int64 (num_groups, bins), float64
        (num_groups, bins + 1) and int64 (num_groups,).  A group without
        values has zero counts and edges of NaN.

    """
    device = values.device
    values = values.reshape(-1).to(torch.float64)
    groups = groups.reshape(-1)
    keep = groups >= 0
    if not bool(keep.all()):
        values, groups = values[keep], groups[keep]
    f64 = {"dtype": torch.float64, "device": device}
    first = torch.full((num_groups,), torch.inf, **f64).scatter_reduce(0, groups, values, "amin")
    last = torch.full((num_groups,), -torch.inf, **f64).scatter_reduce(0, groups, values, "amax")
    sizes = torch.bincount(groups, minlength=num_groups)
    first_h, last_h, sizes_h = (as_numpy(t) for t in (first, last, sizes))

    # numpy's outer edges and linspace, per group on the host.
    edges = np.full((num_groups, bins + 1), np.nan)
    lo, hi = first_h.copy(), last_h.copy()
    for g in np.flatnonzero(sizes_h):
        if not (np.isfinite(lo[g]) and np.isfinite(hi[g])):
            raise ValueError(f"autodetected range of [{lo[g]}, {hi[g]}] is not finite")
        if lo[g] == hi[g]:
            lo[g], hi[g] = lo[g] - 0.5, hi[g] + 0.5
        edges[g] = np.linspace(lo[g], hi[g], bins + 1)
    if values.numel() == 0:
        return np.zeros((num_groups, bins), dtype=np.int64), edges, sizes_h

    # numpy's bin index: scaled and truncated, the top value in the last
    # bin, then one step down or up where the edges disagree.
    edges_d = torch.as_tensor(edges, **f64)
    lo_d, hi_d = torch.as_tensor(lo, **f64), torch.as_tensor(hi, **f64)
    first_v = lo_d[groups]
    index = ((values - first_v) / (hi_d[groups] - first_v) * bins).to(torch.int64)
    index = index - (index == bins).to(torch.int64)
    flat = groups * (bins + 1)
    edges_flat = edges_d.reshape(-1)
    index = index - (values < edges_flat[flat + index]).to(torch.int64)
    step_up = (values >= edges_flat[flat + index + 1]) & (index != bins - 1)
    index = index + step_up.to(torch.int64)
    counts = torch.bincount(groups * bins + index, minlength=num_groups * bins)
    return as_numpy(counts.reshape(num_groups, bins)), edges, sizes_h


def _otsu_from_histogram(hist: np.ndarray, edges: np.ndarray) -> float:
    """Otsu's split of a histogram, at the midpoint of the between-class
    variance's plateau (the JAX package's rule)."""
    centers = 0.5 * (edges[:-1] + edges[1:])
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return float(centers[0])
    w0 = np.cumsum(hist)
    w1 = total - w0
    m = np.cumsum(hist * centers)
    m_total = m[-1]
    mu0 = np.where(w0 > 0, m / np.maximum(w0, 1), 0.0)
    mu1 = np.where(w1 > 0, (m_total - m) / np.maximum(w1, 1), 0.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    # An empty gap of the histogram makes a plateau of equally good splits:
    # take its midpoint.
    imax = int(np.argmax(between))
    floor = (1.0 - 1e-12) * between[imax]
    lo = imax
    while lo > 0 and between[lo - 1] >= floor:
        lo -= 1
    hi = imax
    while hi < len(between) - 1 and between[hi + 1] >= floor:
        hi += 1
    i = (lo + hi) // 2
    # The split after bin i lies at the bin's right edge.
    return float(edges[i + 1])


def _two_peak_from_histogram(hist: np.ndarray, edges: np.ndarray) -> float:
    """The valley between the two highest peaks of the smoothed histogram
    (Otsu where there are fewer than two peaks)."""
    centers = 0.5 * (edges[:-1] + edges[1:])
    smooth = np.convolve(hist, np.ones(5) / 5, mode="same")
    peaks = [
        i
        for i in range(1, len(smooth) - 1)
        if smooth[i] >= smooth[i - 1] and smooth[i] >= smooth[i + 1]
    ]
    if len(peaks) < 2:
        return _otsu_from_histogram(hist, edges)
    order = np.argsort(smooth[peaks])[::-1]
    p1, p2 = sorted([peaks[order[0]], peaks[order[1]]])
    # A flat zero valley: its midpoint.
    segment = smooth[p1 : p2 + 1]
    valley_plateau = np.flatnonzero(segment <= segment.min() + 1e-12)
    valley = p1 + int(valley_plateau[len(valley_plateau) // 2])
    return float(centers[valley])


def _histogram(values, bins: int):
    """(hist, edges) of ``np.histogram`` for a tensor (on its device) or an
    array (on the host), or None for no values."""
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.asarray(values, dtype=np.float64))
    if values.numel() == 0:
        return None
    groups = torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    counts, edges, _ = label_histograms(values, groups, 1, bins)
    return counts[0], edges[0]


def otsu_threshold(values, bins: int = 256) -> float:
    """Otsu's threshold of a sample set (an array, or a tensor histogrammed
    on its device)."""
    histogram = _histogram(values, bins)
    return 0.0 if histogram is None else _otsu_from_histogram(*histogram)


class HistogrammBasedThresholding:
    """Base: a threshold from the histogram of the (masked) signal."""

    def __call__(self, signal, mask=None, bins: int = 256) -> float:
        values = signal
        if mask is not None:
            if isinstance(values, torch.Tensor):
                values = values[as_tensor(mask, values.device).to(torch.bool)]
            else:
                values = np.asarray(values)[np.asarray(mask, dtype=bool)]
        return self._analysis(values, bins)

    def _analysis(self, values, bins: int) -> float:
        histogram = _histogram(values, bins)
        return 0.0 if histogram is None else self.from_histogram(*histogram)

    def from_histogram(self, hist: np.ndarray, edges: np.ndarray) -> float:
        """The threshold of a histogram of non-empty values."""
        raise NotImplementedError


class StandardOtsu(HistogrammBasedThresholding):
    """Plain Otsu thresholding."""

    def from_histogram(self, hist, edges):
        return _otsu_from_histogram(hist, edges)


class TwoPeakHistogrammAnalysis(HistogrammBasedThresholding):
    """Threshold at the valley between the two dominant histogram peaks."""

    def from_histogram(self, hist, edges):
        return _two_peak_from_histogram(hist, edges)


class GlobalMinTwoPeakHistogrammAnalysis(TwoPeakHistogrammAnalysis):
    """Valley = global minimum between the peaks (the base's rule)."""


class OtsuTwoPeakHistogrammAnalysis(TwoPeakHistogrammAnalysis):
    """Otsu's split of the same histogram (the JAX package computes the
    valley and returns Otsu's threshold)."""

    def from_histogram(self, hist, edges):
        return _otsu_from_histogram(hist, edges)


class DynamicThresholdModel(StaticThresholdModel):
    """Threshold model re-calibrated on every image, with bounds and memory.

    Each call derives the per-label thresholds from the signal's histogram
    (method "otsu" or "two-peak"), clamped to [threshold_min,
    threshold_max]; a label without data keeps its last value.
    """

    def __init__(
        self,
        key: str = "",
        method: Literal["otsu", "two-peak"] = "otsu",
        threshold_min: float = 0.0,
        threshold_max: float = 1.0,
        labels=None,
        **kwargs,
    ) -> None:
        super().__init__(
            threshold_lower=kwargs.get(key + "threshold", threshold_min),
            threshold_upper=None,
            labels=labels,
        )
        self.method = method
        self.threshold_min = threshold_min
        self.threshold_max = threshold_max
        self._analyzer = (
            StandardOtsu() if method == "otsu" else TwoPeakHistogrammAnalysis()
        )

    def __call__(self, img, mask=None):
        self.calibrate([img], mask)
        return super().__call__(img, mask)

    def calibrate(self, imgs: list, mask=None) -> None:
        signal = imgs[0].img if hasattr(imgs[0], "img") else imgs[0]
        signal = as_tensor(signal)
        if self._is_homogeneous:
            t = self._analyzer(signal, mask)
            self._threshold_lower = float(
                np.clip(t, self.threshold_min, self.threshold_max)
            )
            return
        groups = self._label_index.on(signal.device)
        if mask is not None:
            inside = as_tensor(mask, signal.device).to(torch.bool)
            groups = torch.where(inside, groups, -1)
        counts, edges, sizes = label_histograms(signal, groups, len(self._unique_labels))
        for i in np.flatnonzero(sizes):
            t = self._analyzer.from_histogram(counts[i], edges[i])
            self._threshold_lower[i] = np.clip(t, self.threshold_min, self.threshold_max)
