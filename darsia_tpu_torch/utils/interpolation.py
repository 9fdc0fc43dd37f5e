"""Scattered-data interpolation: the thin-plate spline of the registration.

Counterpart of :func:`darsia_tpu.utils.interpolation.rbf_interpolate`.  The
JAX function solves and evaluates in float32 at pixel scale, where the
r^2 log r kernel reaches ~1e7 and cancels to a few pixels.  Here the
(N + 3)^2 system is solved in float64 on the host, in coordinates scaled by
1 / max |points|, and evaluated in float64 in blocks on the query's device.
The rescale is exact: sum_i w_i r_i^2 is constant in the query point by the
TPS side conditions (sum w = 0, sum w p = 0), so the scaled interpolant
equals the unscaled one; only the conditioning changes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rbf_interpolate"]

#: Queries evaluated per block: a (block, N) float64 kernel matrix at a time.
_BLOCK = 1 << 16


def _tps_kernel(r):
    """Thin-plate kernel r^2 log r (numpy or torch)."""
    if isinstance(r, torch.Tensor):
        safe = torch.where(r > 0, r, torch.ones_like(r))
        return torch.where(r > 0, r * r * torch.log(safe), torch.zeros_like(r))
    safe = np.where(r > 0, r, 1.0)
    return np.where(r > 0, r * r * np.log(safe), 0.0)


def rbf_interpolate(points, values, query, smoothing: float = 0.0) -> torch.Tensor:
    """Thin-plate-spline RBF interpolation.

    Args:
        points: (N, 2) sample locations (numpy or sequence).
        values: (N,) sample values.
        query: (M, 2) evaluation locations: a tensor (evaluated on its
            device) or a numpy array (evaluated on the CPU).
        smoothing: Tikhonov smoothing on the kernel diagonal (in the
            caller's units).

    Returns:
        (M,) float32 tensor on the query's device.

    """
    P = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    n = P.shape[0]
    scale = 1.0 / max(float(np.abs(P).max()), np.finfo(np.float64).tiny)
    Pn = P * scale
    K = _tps_kernel(np.linalg.norm(Pn[:, None, :] - Pn[None, :, :], axis=-1))
    # The kernel scales by s^2 under the rescale, so the smoothing does too.
    K = K + smoothing * scale**2 * np.eye(n)
    poly = np.concatenate([np.ones((n, 1)), Pn], axis=1)
    A = np.block([[K, poly], [poly.T, np.zeros((3, 3))]])
    sol = np.linalg.solve(A, np.concatenate([v, np.zeros(3)]))

    Q = torch.as_tensor(query)
    device = Q.device
    Q = Q.reshape(-1, 2).to(torch.float64) * scale
    Pt = torch.from_numpy(Pn).to(device)
    w = torch.from_numpy(sol[:n]).to(device)
    c = torch.from_numpy(sol[n:]).to(device)
    p_sq = (Pt * Pt).sum(-1)
    out = []
    for Qb in Q.split(_BLOCK):
        # The matmul distance trick: no (block, N, 2) broadcast.
        d2 = ((Qb * Qb).sum(-1, keepdim=True) - 2.0 * (Qb @ Pt.T) + p_sq).clamp(min=0.0)
        out.append(_tps_kernel(d2.sqrt()) @ w + c[0] + Qb @ c[1:])
    return torch.cat(out).to(torch.float32)
