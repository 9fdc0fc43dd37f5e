"""Automatic color checker detection in an image corner.

Counterpart of :mod:`darsia_tpu.corrections.color.colorcheckerfinder`, a
numpy copy (setup-time code): candidate rectangles in the requested corner
are scored by a 4x6 swatch-grid statistic (diverse cell colors, uniform
cells) from integral images, refined by hill-climbing, and the winning
grid is oriented against the post-2014 X-Rite reference swatches.  A tensor
input is read to the host once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...image.image import as_numpy
from .colorcorrection import ColorCheckerAfter2014, CustomColorChecker

__all__ = ["ColorCheckerPosition", "find_colorchecker"]

ColorCheckerPosition = str  # "upper_left" | "upper_right" | "lower_left" | "lower_right"

_GRID = (4, 6)  # rows x cols of the classic checker


def _integral(arr: np.ndarray) -> np.ndarray:
    """Zero-padded 2d integral image per channel."""
    out = np.zeros((arr.shape[0] + 1, arr.shape[1] + 1) + arr.shape[2:], arr.dtype)
    np.cumsum(np.cumsum(arr, axis=0), axis=1, out=out[1:, 1:])
    return out


def _box_sum(ii: np.ndarray, r0, c0, r1, c1):
    """Sum over [r0:r1, c0:c1) from an integral image (vectorized)."""
    return ii[r1, c1] - ii[r0, c1] - ii[r1, c0] + ii[r0, c0]


def _cell_stats_batch(ii, ii2, r0, c0, h, w):
    """Per-cell means and variances of the 4x6 grid for a BATCH of
    candidate rectangles (vectorized over positions).

    Args:
        r0, c0: int arrays of shape (N,) — rectangle corners.
        h, w: scalar rectangle height/width (shared by the batch).

    Returns:
        means (N, 4, 6, 3), variances (N, 4, 6, 3).
    """
    rows, cols = _GRID
    r0 = np.atleast_1d(np.asarray(r0, dtype=np.int64))
    c0 = np.atleast_1d(np.asarray(c0, dtype=np.int64))
    ch, cw = h / rows, w / cols
    margin_r, margin_c = int(0.18 * ch), int(0.18 * cw)
    i = np.arange(rows)
    j = np.arange(cols)
    # Cell corners: (N, rows) and (N, cols), margin-inset.
    a0 = r0[:, None] + (i * ch).astype(np.int64)[None, :] + margin_r
    a1 = r0[:, None] + ((i + 1) * ch).astype(np.int64)[None, :] - margin_r
    a1 = np.maximum(a1, a0 + 1)
    b0 = c0[:, None] + (j * cw).astype(np.int64)[None, :] + margin_c
    b1 = c0[:, None] + ((j + 1) * cw).astype(np.int64)[None, :] - margin_c
    b1 = np.maximum(b1, b0 + 1)
    # Broadcast to (N, rows, cols).
    A0, B0 = a0[:, :, None], b0[:, None, :]
    A1, B1 = a1[:, :, None], b1[:, None, :]
    n = ((A1 - A0) * (B1 - B0))[..., None]

    def box(integral):
        return (
            integral[A1, B1] - integral[A0, B1] - integral[A1, B0] + integral[A0, B0]
        )

    s = box(ii)
    s2 = box(ii2)
    means = s / n
    variances = np.maximum(s2 / n - means**2, 0.0)
    return means, variances


def _cell_stats(ii, ii2, r0, c0, h, w):
    """Single-rectangle variant of :func:`_cell_stats_batch`."""
    means, variances = _cell_stats_batch(ii, ii2, [r0], [c0], h, w)
    return means[0], variances[0]


def _score_batch(means: np.ndarray, variances: np.ndarray) -> np.ndarray:
    """Vectorized checker-likeness score over a batch (N, 4, 6, 3)."""
    flat = means.reshape(means.shape[0], -1, 3)
    inter = flat.std(axis=1).sum(axis=-1)
    intra = np.sqrt(variances).mean(axis=(1, 2, 3)) * 3
    luminance = flat.mean(axis=-1)
    dynamic = luminance.max(axis=1) - luminance.min(axis=1)
    row_saturation = np.abs(
        means - means.mean(axis=-1, keepdims=True)
    ).mean(axis=(2, 3))
    gray_row = row_saturation.min(axis=1)
    dh = np.linalg.norm(means[:, :, 1:] - means[:, :, :-1], axis=-1)
    dv = np.linalg.norm(means[:, 1:, :] - means[:, :-1, :], axis=-1)
    adjacent = np.concatenate(
        [dh.reshape(means.shape[0], -1), dv.reshape(means.shape[0], -1)],
        axis=1,
    )
    duplicate_fraction = (adjacent < 0.05).mean(axis=1)
    return inter + dynamic - 4.0 * intra - 2.0 * gray_row - 3.0 * duplicate_fraction


def _score(means: np.ndarray, variances: np.ndarray) -> float:
    """Checker-likeness: diverse cell colors, uniform cells, gray row."""
    flat = means.reshape(-1, 3)
    inter = float(flat.std(axis=0).sum())
    intra = float(np.sqrt(variances).mean() * 3)
    luminance = flat.mean(axis=1)
    dynamic = float(luminance.max() - luminance.min())
    # One row should be near-gray (the grayscale ramp).
    row_saturation = np.abs(means - means.mean(axis=-1, keepdims=True)).mean(
        axis=(1, 2)
    )
    gray_row = float(row_saturation.min())
    # Neighboring swatches always differ on a real checker: a grid fitted
    # onto a sub-block duplicates adjacent cells, which this term punishes.
    dh = np.linalg.norm(means[:, 1:] - means[:, :-1], axis=-1)
    dv = np.linalg.norm(means[1:, :] - means[:-1, :], axis=-1)
    adjacent = np.concatenate([dh.ravel(), dv.ravel()])
    duplicate_fraction = float((adjacent < 0.05).mean())
    return (
        inter + dynamic - 4.0 * intra - 2.0 * gray_row - 3.0 * duplicate_fraction
    )


def _orient(swatches: np.ndarray) -> np.ndarray:
    """Rotate/flip the 4x6 swatch grid to best match the reference."""
    reference = ColorCheckerAfter2014().swatches_rgb  # (4, 6, 3)
    best, best_corr = swatches, -np.inf
    candidates = [
        swatches,
        swatches[::-1, ::-1],  # 180 degrees
        swatches[::-1, :],  # vertical flip (mirrored photo)
        swatches[:, ::-1],  # horizontal flip
    ]
    for candidate in candidates:
        corr = -float(np.linalg.norm(candidate - reference))
        if corr > best_corr:
            best, best_corr = candidate, corr
    return best


def _refine(ii, ii2, start, qh, qw):
    """Hill-climb (r0, c0, width) from a coarse candidate."""
    score, r0, c0, rh, rw = start
    step = max(min(rh, rw) // 4, 1)
    while step >= 1:
        improved = False
        for dr, dc, ds in (
            (-step, 0, 0), (step, 0, 0), (0, -step, 0), (0, step, 0),
            (0, 0, -step), (0, 0, step),
            (-step, -step, 0), (step, step, 0),
            (-step, 0, step), (0, -step, step),
            (-step, -step, 2 * step),
        ):
            nw = rw + ds
            nh = int(nw * _GRID[0] / _GRID[1])
            nr, nc = r0 + dr, c0 + dc
            if nr < 0 or nc < 0 or nh < 16 or nw < 24:
                continue
            if nr + nh > qh or nc + nw > qw:
                continue
            means, variances = _cell_stats(ii, ii2, nr, nc, nh, nw)
            s = _score(means, variances)
            if s > score:
                score, r0, c0, rh, rw = s, nr, nc, nh, nw
                improved = True
        if not improved:
            step //= 2
    return score, r0, c0, rh, rw


def find_colorchecker(
    img,
    strategy: ColorCheckerPosition = "upper_right",
    update: float = 0.8,
    min_score: float = 0.5,
) -> Tuple[CustomColorChecker, np.ndarray]:
    """Detect the color checker in the requested image corner.

    Returns:
        (CustomColorChecker with the detected swatch colors,
         (4, 2) voxel corners TL-BL-BR-TR, starting at the brown swatch)
    """
    arr = np.asarray(as_numpy(img.img if hasattr(img, "img") else img), dtype=float)
    if arr.max() > 1.5:
        arr = arr / 255.0
    H, W = arr.shape[:2]

    # Downscale for the search.
    scale = max(1, int(np.ceil(max(H, W) / 600)))
    small = arr[::scale, ::scale]
    h, w = small.shape[:2]

    # Corner quadrant.
    row_half = slice(0, h // 2) if strategy.startswith("upper") else slice(h // 2, h)
    col_half = (
        slice(0, w // 2) if strategy.endswith("left") else slice(w // 2, w)
    )
    quad = small[row_half, col_half]
    qr0, qc0 = row_half.start, col_half.start
    qh, qw = quad.shape[:2]

    ii = _integral(quad)
    ii2 = _integral(quad**2)

    candidates = []  # (score, r0, c0, rh, rw)
    for frac in np.linspace(0.2, 0.95, 9):
        rw = int(frac * qw)
        rh = int(rw * _GRID[0] / _GRID[1])
        if rh < 16 or rw < 24 or rh > qh:
            continue
        stride_r = max((qh - rh) // 16, 2)
        stride_c = max((qw - rw) // 16, 2)
        r0s = np.arange(0, qh - rh + 1, stride_r)
        c0s = np.arange(0, qw - rw + 1, stride_c)
        R0, C0 = np.meshgrid(r0s, c0s, indexing="ij")
        means, variances = _cell_stats_batch(
            ii, ii2, R0.ravel(), C0.ravel(), rh, rw
        )
        scores = _score_batch(means, variances)
        candidates.extend(
            (float(s), int(r), int(c), rh, rw)
            for s, r, c in zip(scores, R0.ravel(), C0.ravel())
        )

    if not candidates:
        raise ValueError("Image too small for color checker detection.")
    candidates.sort(key=lambda t: -t[0])

    # Multi-start hill-climbing refinement from the top coarse candidates:
    # jointly adjust position and size with shrinking steps.
    best = None
    for start in candidates[:5]:
        refined = _refine(ii, ii2, start, qh, qw)
        if best is None or refined[0] > best[0]:
            best = refined
    score, r0, c0, rh, rw = best
    if score < min_score:
        # Real checkers score > ~1; textured rig photos without one peak
        # well below zero.
        raise ValueError(
            f"No color checker found in {strategy} corner "
            f"(best score {score:.2f} < {min_score})."
        )
    means, _ = _cell_stats(ii, ii2, r0, c0, rh, rw)
    swatches = _orient(means)
    checker = CustomColorChecker(reference_colors=swatches)

    # Corners in full resolution, TL-BL-BR-TR (row, col).
    top, left = (qr0 + r0) * scale, (qc0 + c0) * scale
    bottom, right = (qr0 + r0 + rh) * scale, (qc0 + c0 + rw) * scale
    voxels = np.array(
        [[top, left], [bottom, left], [bottom, right], [top, right]]
    )
    return checker, voxels
