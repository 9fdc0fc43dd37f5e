"""One-dimensional piecewise-linear interpolation on tensors.

PyTorch has no ``numpy.interp``.  :func:`interp` follows ``jnp.interp``
(``jax/_src/numpy/lax_numpy.py::_interp``, without ``period``): the right
insertion index clamped to [1, n - 1], the segment's lerp with a guard
against a zero-width segment, and the end values outside the supports.
Every step is its own tensor op, so no multiply-add is contracted; XLA may
contract ``fp[i-1] + (delta / dx) * df`` on the CPU, which puts the two
about one ulp apart there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["interp"]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for a tensor ``x`` of any shape and 1-D
    tensors ``xp`` (ascending) and ``fp`` of one length, on ``x``'s device."""
    if xp.dim() != 1 or xp.shape != fp.shape:
        raise ValueError("xp and fp must be one-dimensional arrays of equal size")
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp_(1, n - 1)
    lo_x, hi_x = xp[i - 1], xp[i]
    lo_f = fp[i - 1]
    df = fp[i] - lo_f
    dx = hi_x - lo_x
    delta = x - lo_x
    epsilon = float(np.spacing(np.finfo(torch.finfo(xp.dtype).dtype).eps))
    dx0 = dx.abs() <= epsilon
    f = torch.where(dx0, lo_f, lo_f + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
