"""Array arithmetic helpers (counterpart of :mod:`darsia_tpu.utils.arithmetics`;
numpy, copied)."""

from __future__ import annotations

import numpy as np

__all__ = ["array_product"]


def array_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Product of two arrays that may differ by one trailing axis.

    The common workflow case is scaling a multichromatic stack
    ``(H, W, C)`` by a scalar field ``(H, W)`` — the lower-rank operand
    is broadcast along the extra trailing axis of the higher-rank one.
    """
    a, b = np.asarray(a), np.asarray(b)
    lo, hi = (a, b) if a.ndim <= b.ndim else (b, a)
    if lo.shape == hi.shape:
        return a * b
    if hi.ndim == lo.ndim + 1 and hi.shape[:-1] == lo.shape:
        return hi * lo[..., np.newaxis]
    raise ValueError("Shapes not compatible.")
