"""Colour-path regression for labelled images.

Counterpart of :mod:`darsia_tpu.signals.color.color_path_regression`: base
colours -> per-label relative colour spectra -> weighted 1D embedding ->
piecewise-linear path nodes -> ``ColorPath`` per label.

Two parts touch data at scale and run on the data's device:

* :meth:`LabelColorPathMapRegression.get_color_spectrum` makes one pass per
  photograph: the float64 relative colour, its bin id (``color_to_index``,
  float64, round half to even), ``label_index * R^3 + bin`` and one
  ``torch.bincount`` give every label's counts, read back in one host read.
  The counts are those of the JAX package's per-label ``np.unique`` loop,
  merged into each spectrum in the same order.
* ``fit_mode="rdp"`` evaluates all candidate splits of one split at once
  (:func:`_segment_errors`, float64): the chord lengths are summed on the
  host in numpy's sequential order, the 80th percentile is a sort plus
  numpy's own linear interpolation.  The smoothing of the errors and the
  crossing search stay on the host (:func:`_rdp_nodes`).
  :meth:`LabelColorPathMapRegression._fit_path_rdp_reference` is the JAX
  package's host loop, kept as the plain version.

The spectra hold at most a few thousand occupied bins: their expansion, the
weights and the embedding are host numpy in float64, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from .color_mode import ColorMode
from .color_path import ColorPath
from .color_range import ColorSpectrum, color_to_index, flatten_index
from .label_maps import LabelColorMap, LabelColorPathMap, LabelColorSpectrumMap
from .utils import get_mean_color

__all__ = ["LabelColorPathMapRegression"]

#: The quantile of a segment's L1 fit errors that scores it.
_QUANTILE = 0.8
#: Bytes of float64 temporaries one batch of segment errors may hold.
_CHUNK_BYTES = 1 << 30


def _img(x):
    return x.img if hasattr(x, "img") else x


def _chord_rows(lens: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Per start ``p`` the row ``[0, cumsum(lens[p:p + width - 1])]`` (zeros
    past the end of ``lens``), summed in numpy's sequential order, so that
    each row equals the chord parameter of a segment starting at ``p``."""
    padded = np.concatenate([lens, np.zeros(width)])
    windows = np.lib.stride_tricks.sliding_window_view(padded, width - 1)[starts]
    return np.concatenate([np.zeros((len(starts), 1)), np.cumsum(windows, axis=1)], axis=1)


def _segment_errors(
    colors: torch.Tensor, lens: np.ndarray, starts: np.ndarray, lengths: np.ndarray
) -> np.ndarray:
    """The outlier-robust error of each segment ``colors[p:p + L]`` (the 80th
    percentile of the L1 distances to its chord-length linear fit; 0 below 3
    points), all on ``colors``' device in float64, in batches of at most
    ``_CHUNK_BYTES``.  Equal to the JAX package's ``segment_error`` of each
    segment: the same operations in the same order.  Returns host float64."""
    out = np.zeros(len(starts))
    scored = np.nonzero(lengths >= 3)[0]
    if len(scored) == 0:
        return out
    device = colors.device
    n = colors.shape[0]
    width = int(lengths[scored].max())
    unique_starts, row_of = np.unique(starts[scored], return_inverse=True)
    chords = torch.from_numpy(_chord_rows(lens, unique_starts, width)).to(device)
    cols = torch.arange(width, device=device)
    # Five (segments, width, 3) float64 temporaries at most.
    per_chunk = max(1, _CHUNK_BYTES // (5 * 3 * 8 * width))
    for lo in range(0, len(scored), per_chunk):
        pick = scored[lo : lo + per_chunk]
        length = torch.from_numpy(lengths[pick]).to(device)
        start = torch.from_numpy(starts[pick]).to(device)
        t = chords[torch.from_numpy(row_of[lo : lo + per_chunk]).to(device)]
        span = t.gather(1, (length - 1)[:, None])
        t = t / torch.where(span > 1e-30, span, torch.ones_like(span))
        idx = (start[:, None] + cols[None, :]).clamp(max=n - 1)
        c = colors[idx]
        first = colors[start][:, None, :]
        last = colors[start + length - 1][:, None, :]
        pred = first + t[:, :, None] * (last - first)
        e = (pred - c).abs()
        e = (e[..., 0] + e[..., 1]) + e[..., 2]
        e = torch.where(cols[None, :] < length[:, None], e, torch.full_like(e, float("inf")))
        e = e.sort(dim=1).values
        # numpy's "linear" quantile: virtual index (L - 1) q, then _lerp.
        virtual = (lengths[pick] - 1) * _QUANTILE
        below = np.floor(virtual)
        gamma = torch.from_numpy(virtual - below).to(device)
        below = torch.from_numpy(below.astype(np.int64)).to(device)
        a = e.gather(1, below[:, None])[:, 0]
        b = e.gather(1, (below + 1)[:, None])[:, 0]
        diff = b - a
        q = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
        out[pick] = q.cpu().numpy()
    return out


def _reference_segment_error(sorted_colors: np.ndarray, rng: range) -> float:
    """The JAX package's ``segment_error``: outlier-robust (80th-percentile)
    L1 linear-fit error with chord-length parametrization."""
    idx = np.arange(rng.start, rng.stop)
    if len(idx) < 3:
        return 0.0
    c = sorted_colors[idx]
    seg_lens = np.linalg.norm(np.diff(c, axis=0), axis=1)
    t = np.concatenate([[0.0], np.cumsum(seg_lens)])
    span = t[-1]
    t = t / (span if span > 1e-30 else 1.0)
    pred = c[0] + np.outer(t, c[-1] - c[0])
    errors = np.abs(pred - c).sum(axis=1)
    return float(np.quantile(errors, _QUANTILE))


def _rdp_sorted(relative_colors, embedding) -> tuple:
    """Colours and embedding sorted along the embedding, trimmed left of the
    origin (flipped if it sits at the right end), with the exact origin
    prepended."""
    order = np.argsort(embedding)
    sorted_colors = relative_colors[order]
    sorted_embedding = embedding[order]
    origin = np.zeros(3)
    origin_index = int(np.argmin(np.linalg.norm(sorted_colors - origin, axis=1)))
    if origin_index > len(sorted_colors) // 2:
        origin_index = len(sorted_colors) - origin_index - 1
        sorted_embedding = np.flip(sorted_embedding, axis=0)
        sorted_colors = np.flip(sorted_colors, axis=0)
    sorted_embedding = sorted_embedding[origin_index:]
    sorted_colors = sorted_colors[origin_index:, :]
    sorted_embedding = np.hstack(
        (
            sorted_embedding[0] + np.sign(sorted_embedding[0] - sorted_embedding[-1]),
            sorted_embedding,
        )
    )
    sorted_colors = np.vstack((origin, sorted_colors))
    return sorted_colors, sorted_embedding


def _rdp_nodes(
    sorted_colors: np.ndarray,
    sorted_embedding: np.ndarray,
    num_segments: int,
    split_errors,
    segment_error,
    trace: Optional[list] = None,
) -> np.ndarray:
    """The JAX package's greedy segmentation: split the worst segment at the
    smoothed left/right error crossover closest to its centre, then sweep
    neighbour pairs until converged or oscillating; the nodes are the
    segment ends.  ``split_errors(rng)`` gives the left and right errors of
    every candidate split of ``rng``; ``segment_error(rng)`` one segment's.
    With ``trace`` each split appends ``(start, stop, split, smoothed
    left - right)``."""

    def segment_length(rng: range) -> float:
        return float(abs(sorted_embedding[rng.stop - 1] - sorted_embedding[rng.start]))

    def split_segment(rng: range):
        pts = np.arange(1, len(rng) - 1)
        left_err, right_err = split_errors(rng)
        if len(pts) >= 5:
            from scipy.signal import savgol_filter

            window = min(5, len(pts) if len(pts) % 2 else len(pts) - 1)
            left_s = savgol_filter(left_err, window, polyorder=2)
            right_s = savgol_filter(right_err, window, polyorder=2)
        else:
            left_s, right_s = left_err, right_err
        diff = left_s - right_s
        crossings = np.where(np.diff(np.sign(diff)))[0]
        if len(crossings) == 0:
            k = int(np.argmin(np.abs(diff)))
        else:
            center = len(rng) / 2
            k = int(crossings[np.argmin(np.abs(pts[crossings] - center))])
        split = int(pts[k])
        if trace is not None:
            trace.append((rng.start, rng.stop, split, diff))
        left_rng, right_rng = rng[:split], rng[split:]
        return (
            {"range": left_rng, "error": float(left_err[k]), "length": segment_length(left_rng)},
            {"range": right_rng, "error": float(right_err[k]), "length": segment_length(right_rng)},
        )

    full = range(0, len(sorted_embedding))
    segments = [{"range": full, "error": segment_error(full), "length": segment_length(full)}]

    while len(segments) < num_segments:
        eligible = [s for s in segments if len(s["range"]) > 2]
        if not eligible:
            break
        worst = eligible[int(np.argmax([s["error"] for s in eligible]))]
        left, right = split_segment(worst["range"])
        i = segments.index(worst)
        segments[i] = left
        segments.insert(i + 1, right)

    old_distances: list[int] = []
    for _ in range(10):
        previous = [dict(s) for s in segments]
        for i in range(len(segments) - 1):
            combined = range(segments[i]["range"].start, segments[i + 1]["range"].stop)
            if len(combined) < 3:
                continue
            segments[i], segments[i + 1] = split_segment(combined)
        if all(segments[i]["range"] == previous[i]["range"] for i in range(len(segments))):
            break
        distance = sum(
            abs(segments[i]["range"].start - previous[i]["range"].start)
            + abs(segments[i]["range"].stop - previous[i]["range"].stop)
            for i in range(len(segments))
        )
        old_distances.append(distance)
        if len(old_distances) > 5 and len(np.unique(old_distances[-5:])) == 1:
            break  # oscillation detected

    node_colors = [sorted_colors[s["range"].start] for s in segments]
    node_colors.append(sorted_colors[segments[-1]["range"].stop - 1])
    while len(node_colors) < num_segments + 1:
        node_colors.append(node_colors[-1])
    return np.asarray(node_colors)


class LabelColorPathMapRegression:
    """Regress relative colour paths per label from calibration images.

    The labels (and the mask) are moved to the photographs' device; the
    segmentation fit runs on the labels' device (a numpy label array: the
    CUDA card)."""

    def __init__(
        self,
        labels,
        color_range=None,
        resolution: int = 11,
        mask=None,
        ignore_labels: Optional[list] = None,
        color_mode: ColorMode = ColorMode.RELATIVE,
    ) -> None:
        self.labels = labels
        self.color_range = color_range
        self.resolution = resolution
        self.mask = mask
        self.ignore_labels = list(ignore_labels or [])
        self.color_mode = getattr(color_range, "color_mode", None) or color_mode
        if self.color_mode != ColorMode.RELATIVE:
            raise NotImplementedError("Color path regression only implemented for RELATIVE mode.")
        self._labels = as_tensor(_img(labels))
        self.device = self._labels.device

    # ----------------------------------------------------------- base colour

    def _labels_on(self, device) -> torch.Tensor:
        return self._labels.to(device)

    def _mask_on(self, device) -> torch.Tensor:
        if self.mask is None:
            return torch.ones(self._labels_on(device).shape, dtype=torch.bool, device=device)
        return as_tensor(_img(self.mask), device).to(torch.bool)

    def _unique_labels(self) -> list:
        return [int(v) for v in torch.unique(self._labels_on(self.device)).tolist()]

    def get_base_colors(self, image) -> LabelColorMap:
        """Median colour per label under the mask, on the image's device."""
        device = as_tensor(_img(image)).device
        labels = self._labels_on(device)
        mask = self._mask_on(device)
        base_colors = {}
        for label in self._unique_labels():
            if label in self.ignore_labels:
                base_colors[label] = np.zeros(3)
                continue
            region = mask & (labels == label)
            if not bool(region.any()):
                base_colors[label] = np.zeros(3)
                continue
            base_colors[label] = get_mean_color(image, mask=region)
        return LabelColorMap(base_colors)

    def get_mean_base_color(self, image) -> np.ndarray:
        base_colors = self.get_base_colors(image)
        return np.mean(np.stack(list(base_colors.values())), axis=0)

    def base_color_image(self, image):
        """Image with each label painted by its base colour."""
        base_colors = self.get_base_colors(image)
        out = image.copy()
        data = as_tensor(out.img).clone()
        labels = self._labels_on(data.device)
        for label, color in base_colors.items():
            data[labels == label] = torch.as_tensor(color, device=data.device).to(data.dtype)
        out.img = data
        return out

    # -------------------------------------------------------------- spectrum

    def get_color_spectrum(
        self,
        images: list,
        baseline=None,
        ignore=None,
        threshold_zero: float = 0.0,
        threshold_significant: float = 0.0,
        path: Optional[Path] = None,
        verbose: bool = False,
    ) -> LabelColorSpectrumMap:
        """Per-label spectra of relative colours across calibration images.

        As in the JAX package, pixels outside the mask count as the zero
        colour of their label (their relative colour is zeroed before the
        per-label gather), unless ``threshold_zero > 0`` drops them with
        every colour of norm at most ``threshold_zero``."""
        unique_labels = self._unique_labels()
        if baseline is None:
            base_colors = LabelColorMap({label: np.zeros(3) for label in unique_labels})
        else:
            base_colors = self.get_base_colors(baseline)

        box_lo, box_hi = self._box()
        spectra = LabelColorSpectrumMap()
        for label in unique_labels:
            spectrum = ColorSpectrum(resolution=self.resolution, base_color=base_colors[label])
            spectrum.min_color = box_lo
            spectrum.max_color = box_hi
            spectra[label] = spectrum

        for image in images:
            counts = self.image_counts(image, baseline, threshold_zero)
            for label, (ids, values) in zip(unique_labels, counts):
                if len(ids):
                    merged = dict(spectra[label].counts)
                    for key, value in zip(ids.tolist(), values.tolist()):
                        merged[key] = merged.get(key, 0) + value
                    spectra[label]._set_counts(merged)

        for label in unique_labels:
            if ignore is not None:
                spectra[label].remove(ignore[label] if isinstance(ignore, dict) else ignore)
            spectra[label].threshold(threshold_significant)

        if path is not None:
            spectra.save(path)
        return spectra

    def _box(self) -> tuple:
        """The quantisation box: the colour range's, else [-1, 1]^3."""
        if self.color_range is not None:
            return np.asarray(self.color_range.min_color), np.asarray(self.color_range.max_color)
        return -np.ones(3), np.ones(3)

    def image_counts(self, image, baseline=None, threshold_zero: float = 0.0) -> list:
        """One photograph's per-label histogram of quantised relative colours:
        per label (ascending) the occupied bin ids (ascending) and their
        counts, as host int64 arrays.  One pass on the image's device, one
        host read."""
        data = as_tensor(_img(image))
        device = data.device
        labels = self._labels_on(device)
        unique, inverse = torch.unique(labels, return_inverse=True)
        relative = data.to(torch.float64)
        if baseline is not None:
            relative = relative - as_tensor(_img(baseline), device).to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=device)
        relative = torch.where(self._mask_on(device)[..., None], relative, zero)
        bins = self.resolution**3
        ids = flatten_index(color_to_index(relative, self.resolution, *self._box()), self.resolution)
        keys = inverse * bins + ids
        if threshold_zero > 0.0:
            x, y, z = relative.unbind(-1)
            keep = torch.sqrt((x * x + y * y) + z * z) > threshold_zero
            keys = keys[keep]
        hist = torch.bincount(keys.reshape(-1), minlength=len(unique) * bins)
        occupied = torch.nonzero(hist)[:, 0]
        key_host, count_host = torch.stack([occupied, hist[occupied]]).cpu().numpy()
        which = key_host // bins
        return [
            (key_host[which == k] % bins, count_host[which == k]) for k in range(len(unique))
        ]

    def expand_color_spectrum(self, spectra, iterations: int = 1) -> LabelColorSpectrumMap:
        """Dilate each label's occupancy in quantised colour space; expanded
        bins inherit the smallest observed count."""
        out = LabelColorSpectrumMap()
        for label, spectrum in spectra.items():
            expanded = ColorSpectrum.from_dict(spectrum.to_dict())
            expanded.expand(iterations=iterations)
            floor = min(expanded.counts.values()) if expanded.counts else 1
            expanded.counts = {k: expanded.counts.get(k, floor) for k in expanded.occupancy}
            out[label] = expanded
        return out

    # --------------------------------------------------------------- fitting

    @staticmethod
    def _point_weights(
        spectrum: ColorSpectrum,
        weighting: Literal["threshold", "wls", "wls_sqrt", "wls_log"],
    ) -> np.ndarray:
        probs = spectrum.probabilities
        n = probs.shape[0]
        if weighting == "threshold":
            weights = np.ones(n)
        elif weighting == "wls":
            weights = probs
        elif weighting == "wls_sqrt":
            weights = np.sqrt(probs)
        elif weighting == "wls_log":
            weights = np.log1p(probs * max(n, 1))
        else:
            raise ValueError(f"Unknown weighting {weighting!r}.")
        total = weights.sum()
        return weights / total if total > 0 else np.full(n, 1.0 / max(n, 1))

    def _fit_inputs(
        self,
        spectrum: ColorSpectrum,
        ignore=None,
        weighting: str = "threshold",
        outlier_weight_ratio: float = 0.05,
    ) -> tuple:
        """The relative colours a path is fitted through and their weights:
        the ignored bins dropped, the weights normalised, and for count-based
        weightings the bins far below the dominant one dropped."""
        relative_colors = spectrum.relative_colors
        weights = self._point_weights(spectrum, weighting)
        if ignore is not None and relative_colors.shape[0]:
            keep = ~ignore.contains(spectrum.base_color + relative_colors)
            relative_colors = relative_colors[keep]
            weights = weights[keep]
        if relative_colors.shape[0] <= 1:
            return relative_colors, weights
        weights = weights / max(weights.sum(), 1e-30)
        if weighting != "threshold" and relative_colors.shape[0] > 4:
            keep = weights >= outlier_weight_ratio * weights.max()
            if keep.sum() >= 2:
                relative_colors = relative_colors[keep]
                weights = weights[keep] / weights[keep].sum()
        return relative_colors, weights

    def _find_color_path(
        self,
        spectrum: ColorSpectrum,
        label: Optional[int] = None,
        ignore=None,
        num_segments: int = 1,
        name: str = "Color Path",
        weighting: Literal["threshold", "wls", "wls_sqrt", "wls_log"] = "threshold",
        fit_mode: Literal["rdp", "lloyd"] = "rdp",
        lloyd_iterations: int = 3,
        outlier_weight_ratio: float = 0.05,
        **_ignored,
    ) -> ColorPath:
        """Fit one relative colour path through a spectrum's occupied bins:
        ``fit_mode="rdp"`` the weighted greedy segmentation with
        outlier-robust quantile errors, ``"lloyd"`` quantile seeds and Lloyd
        refinement."""
        num_dofs = num_segments + 1
        relative_colors, weights = self._fit_inputs(spectrum, ignore, weighting, outlier_weight_ratio)
        if relative_colors.shape[0] <= 1:
            return ColorPath(
                base_color=spectrum.base_color,
                relative_colors=num_dofs * [np.zeros(3)],
                name=name,
            )
        embedding = self._embed_1d(relative_colors, weights)
        if fit_mode == "rdp":
            node_colors = self._fit_path_rdp(relative_colors, weights, embedding, num_segments)
        else:
            node_colors = self._fit_path_lloyd(
                spectrum, relative_colors, weights, embedding, num_segments, lloyd_iterations, name
            )
        return ColorPath(
            base_color=spectrum.base_color,
            relative_colors=[c for c in node_colors],
            name=name,
        )

    @staticmethod
    def _embed_1d(relative_colors: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Weighted-PCA 1D embedding oriented so the origin sits at the low
        end (paths start at the base colour)."""
        mean = weights @ relative_colors
        centered = relative_colors - mean
        cov = (centered * weights[:, None]).T @ centered
        _, vecs = np.linalg.eigh(cov)
        direction = vecs[:, -1]
        embedding = centered @ direction
        origin_param = -mean @ direction
        if origin_param > weights @ embedding:
            embedding = -embedding
        return embedding

    def _fit_path_rdp(
        self,
        relative_colors: np.ndarray,
        weights: np.ndarray,
        embedding: np.ndarray,
        num_segments: int,
        trace: Optional[list] = None,
    ) -> np.ndarray:
        """The greedy segmentation with every candidate split of a split
        scored at once on the regression's device."""
        sorted_colors, sorted_embedding = _rdp_sorted(relative_colors, embedding)
        lens = np.linalg.norm(np.diff(sorted_colors, axis=0), axis=1)
        colors = torch.from_numpy(np.ascontiguousarray(sorted_colors)).to(self.device)

        def split_errors(rng: range):
            m = len(rng)
            s = np.arange(1, m - 1)
            starts = np.concatenate([np.full(m - 2, rng.start), rng.start + s])
            lengths = np.concatenate([s, m - s])
            errors = _segment_errors(colors, lens, starts, lengths)
            return errors[: m - 2], errors[m - 2 :]

        def segment_error(rng: range) -> float:
            starts, lengths = np.array([rng.start]), np.array([len(rng)])
            return float(_segment_errors(colors, lens, starts, lengths)[0])

        return _rdp_nodes(sorted_colors, sorted_embedding, num_segments, split_errors, segment_error, trace)

    @staticmethod
    def _fit_path_rdp_reference(
        relative_colors: np.ndarray,
        weights: np.ndarray,
        embedding: np.ndarray,
        num_segments: int,
        trace: Optional[list] = None,
    ) -> np.ndarray:
        """The plain version: the JAX package's host loop, each candidate
        split's errors computed segment by segment in numpy."""
        sorted_colors, sorted_embedding = _rdp_sorted(relative_colors, embedding)

        def segment_error(rng: range) -> float:
            return _reference_segment_error(sorted_colors, rng)

        def split_errors(rng: range):
            splits = range(1, len(rng) - 1)
            return (
                np.asarray([segment_error(rng[:s]) for s in splits]),
                np.asarray([segment_error(rng[s:]) for s in splits]),
            )

        return _rdp_nodes(sorted_colors, sorted_embedding, num_segments, split_errors, segment_error, trace)

    def _fit_path_lloyd(
        self,
        spectrum: ColorSpectrum,
        relative_colors: np.ndarray,
        weights: np.ndarray,
        embedding: np.ndarray,
        num_segments: int,
        lloyd_iterations: int,
        name: str,
    ) -> np.ndarray:
        """Quantile-seeded node placement plus Lloyd refinement; the
        projection is ``ColorPath.fit``'s on the regression's device."""
        num_dofs = num_segments + 1
        num_points = relative_colors.shape[0]
        order = np.argsort(embedding)
        cumw = np.cumsum(weights[order])
        cumw /= cumw[-1]
        node_colors = np.zeros((num_dofs, 3))
        for i in range(1, num_dofs):
            q = i / num_segments
            idx = order[min(np.searchsorted(cumw, q), num_points - 1)]
            node_colors[i] = relative_colors[idx]

        colors = torch.from_numpy(relative_colors).to(self.device)
        for _ in range(lloyd_iterations):
            path = ColorPath(
                base_color=spectrum.base_color,
                relative_colors=[c for c in node_colors],
                name=name,
            )
            params = np.clip(as_numpy(path.fit(colors, ColorMode.RELATIVE, mode="equidistant")), 0.0, 1.0)
            for i in range(1, num_dofs):
                t_i = i / num_segments
                half = 0.5 / num_segments
                sel = np.abs(params - t_i) <= half
                w_sel = weights[sel]
                if w_sel.sum() > 1e-12:
                    node_colors[i] = (w_sel @ relative_colors[sel]) / w_sel.sum()
        return node_colors

    def find_color_path(
        self,
        spectra,
        num_segments: int = 1,
        ignore=None,
        weighting: Literal["threshold", "wls", "wls_sqrt", "wls_log"] = "threshold",
        path: Optional[Path] = None,
        **kwargs,
    ) -> LabelColorPathMap:
        """Fit colour paths for all labels (ignored labels: the zero path)."""
        color_paths = LabelColorPathMap()
        for label, spectrum in spectra.items():
            if label in self.ignore_labels:
                color_paths[label] = ColorPath(
                    base_color=spectrum.base_color,
                    relative_colors=(num_segments + 1) * [np.zeros(3)],
                    name=f"label_{label}",
                )
                continue
            color_paths[label] = self._find_color_path(
                spectrum,
                label=label,
                ignore=ignore[label] if isinstance(ignore, dict) else ignore,
                num_segments=num_segments,
                name=f"label_{label}",
                weighting=weighting,
                **kwargs,
            )
        if path is not None:
            color_paths.save(path)
        return color_paths
