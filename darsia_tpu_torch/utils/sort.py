"""Sorting utilities (counterpart of :mod:`darsia_tpu.utils.sort`; numpy, copied)."""

from __future__ import annotations

import numpy as np

__all__ = ["sort_quad"]


def sort_quad(pts):
    """Sort 4 quadrilateral points (matrix indexing) clockwise:
    top-left, bottom-left, bottom-right, top-right."""
    pts = np.asarray(pts)
    order = np.argsort(pts[:, 0])
    top = pts[order[:2]]
    bottom = pts[order[2:]]
    top = top[np.argsort(top[:, 1])]
    bottom = bottom[np.argsort(bottom[:, 1])]
    return np.array([top[0], bottom[0], bottom[1], top[1]])
