"""Cheung-2004 polynomial color correction.

Counterpart of :mod:`darsia_tpu.ops.polynomial_color`: the polynomial term
expansion of RGB (in float32, as the JAX package forms it), an exact float64
least-squares fit of the correction matrix on the host, and its application
as one float32 matmul on the image's device.  Term sets follow Cheung et al.
2004 (public method description).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_cheung2004", "cheung2004_terms", "colour_correction", "fit_cheung2004"]


def cheung2004_terms(rgb: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """Polynomial expansion of RGB samples (trailing channel axis); term
    counts 3, 5, 7, 8, 10 or 11."""
    R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    one = torch.ones_like(R)
    if terms == 3:
        cols = [R, G, B]
    elif terms == 5:
        cols = [R, G, B, R * G * B, one]
    elif terms == 7:
        cols = [R, G, B, R * G, R * B, G * B, one]
    elif terms == 8:
        cols = [R, G, B, R * G, R * B, G * B, R * G * B, one]
    elif terms == 10:
        cols = [R, G, B, R * G, R * B, G * B, R * R, G * G, B * B, one]
    elif terms == 11:
        cols = [R, G, B, R * G, R * B, G * B, R * R, G * G, B * B, R * G * B, one]
    else:
        raise ValueError(f"Unsupported number of terms {terms}.")
    return torch.stack(cols, dim=-1)


def fit_cheung2004(swatches_src, swatches_dst, terms: int = 3) -> np.ndarray:
    """Exact least-squares fit of the (terms, 3) correction matrix."""
    src = torch.as_tensor(np.asarray(swatches_src, dtype=np.float32))
    X = cheung2004_terms(src, terms).reshape(-1, terms).numpy().astype(np.float64)
    Y = np.asarray(swatches_dst, dtype=np.float64).reshape(-1, 3)
    M, *_ = np.linalg.lstsq(X, Y, rcond=None)
    return M


def apply_cheung2004(img: torch.Tensor, matrix: np.ndarray, terms: int = 3) -> torch.Tensor:
    """A fitted polynomial correction applied to an RGB image (one matmul)."""
    X = cheung2004_terms(img.to(torch.float32), terms)
    M = torch.as_tensor(np.asarray(matrix, dtype=np.float32), device=img.device)
    return X @ M


def colour_correction(img: torch.Tensor, swatches_src, swatches_dst, terms: int = 3):
    """Fit and apply in one call."""
    return apply_cheung2004(img, fit_cheung2004(swatches_src, swatches_dst, terms), terms)
