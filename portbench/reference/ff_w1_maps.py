"""Plain reference of the batched W1 solve (configuration ``ff_w1_maps``).

The Wasserstein-1 distance between two maps on a cell grid, as the
Beckmann problem ``min sum_c V |u|_c  s.t.  div u = V (dst - src)`` on the
grid's interior faces (two-point flux approximation, zero flux through the
boundary), with ``|u|_c`` the 4x4 Gauss quadrature of the lowest-order
Raviart-Thomas reconstruction of the face fluxes over each cell.  It is
solved by the same lagged-mobility (iteratively reweighted) fixed point the
solver runs: a Darcy start with unit face weights, then per iteration the
face weights ``1 / harmonic mean of |u|_c`` (|u|_c floored at 1e-6 of its
peak), the pressure from the weighted TPFA system, the fluxes from the
pressure; the loop stops from the third iteration once the distance moved by
less than ``tol_distance`` of itself, or at ``num_iter``.

Here every pressure system is solved exactly (sparse LU, float64, one cell
pinned against the constant null space) on the host, in place of the
solver's float32 multigrid-preconditioned CG.  ``dtype=bfloat16`` is the
control: fluxes, cell densities, face weights and pressures are rounded to
bfloat16 as they are made, and the maps too.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def _round(x: np.ndarray, dtype) -> np.ndarray:
    if dtype is None:
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(torch.float64).numpy()


class Beckmann:
    """``Beckmann(cfg, dtype=None).distance(src, dst) -> (distance, iterations)``."""

    def __init__(self, cfg: dict, dtype=None) -> None:
        self.shape = tuple(cfg["grid_shape"])
        h = float(cfg["voxel_size"])
        self.cell_vol = h * h
        self.face_vol = h
        opts = cfg["options"]
        self.num_iter = int(opts.get("num_iter", 100))
        self.tol = float(opts.get("tol_distance", np.inf))
        self.dtype = None if dtype in (None, torch.float32, torch.float64) else dtype
        pts, w = np.polynomial.legendre.leggauss(4)
        gy, gx = np.meshgrid(pts, pts, indexing="ij")
        wy, wx = np.meshgrid(w, w, indexing="ij")
        self.qp = np.stack([(gy.ravel() + 1) / 2, (gx.ravel() + 1) / 2], axis=1)
        qw = (wy * wx).ravel()
        self.qw = qw / qw.sum()
        H, W = self.shape
        idx = np.arange(H * W).reshape(H, W)
        # Faces of axis 0 join (i, j) and (i + 1, j); of axis 1 (i, j) and (i, j + 1).
        self.pairs = [
            (idx[:-1, :].ravel(), idx[1:, :].ravel()),
            (idx[:, :-1].ravel(), idx[:, 1:].ravel()),
        ]

    # ------------------------------------------------------------- pieces

    def density(self, u0: np.ndarray, u1: np.ndarray) -> np.ndarray:
        """Per cell: the quadrature of |RT0 flux| (weights summing to 1)."""
        H, W = self.shape
        lo0 = np.zeros((H, W))
        hi0 = np.zeros((H, W))
        lo0[1:, :], hi0[:-1, :] = u0, u0
        lo1 = np.zeros((H, W))
        hi1 = np.zeros((H, W))
        lo1[:, 1:], hi1[:, :-1] = u1, u1
        rho = np.zeros((H, W))
        for (t0, t1), q in zip(self.qp, self.qw):
            c0 = t0 * hi0 + (1 - t0) * lo0
            c1 = t1 * hi1 + (1 - t1) * lo1
            rho += q * np.sqrt(c0 * c0 + c1 * c1)
        return rho

    def face_weights(self, u0, u1):
        rho = self.density(u0, u1)
        rho = np.maximum(rho, max(1e-6 * rho.max(), np.finfo(float).eps))
        rho = _round(rho, self.dtype)
        out = []
        for a, b in ((rho[:-1, :], rho[1:, :]), (rho[:, :-1], rho[:, 1:])):
            s = a + b
            harm = np.where(s > 0, 2.0 * a * b / np.where(s == 0, 1.0, s), 0.0)
            out.append(_round(1.0 / np.maximum(harm, 1e-30), self.dtype))
        return out

    def pressure(self, fw, rhs):
        """Exact solve of D diag(face_vol^2 / (fw V)) D^T p = rhs, p pinned
        to 0 in the first cell."""
        H, W = self.shape
        n = H * W
        rows, cols, vals = [], [], []
        diag = np.zeros(n)
        for (a, b), f in zip(self.pairs, fw):
            t = (self.face_vol**2) / (f.ravel() * self.cell_vol)
            rows += [a, b]
            cols += [b, a]
            vals += [-t, -t]
            np.add.at(diag, a, t)
            np.add.at(diag, b, t)
        A = sp.coo_matrix(
            (np.concatenate(vals + [diag]), (np.concatenate(rows + [np.arange(n)]), np.concatenate(cols + [np.arange(n)]))),
            shape=(n, n),
        ).tocsc()
        p = np.zeros(n)
        p[1:] = spla.splu(A[1:, 1:]).solve(rhs.ravel()[1:] - 0.0)
        return _round(p.reshape(H, W), self.dtype)

    def fluxes(self, fw, p):
        g0 = self.face_vol * (p[:-1, :] - p[1:, :])
        g1 = self.face_vol * (p[:, :-1] - p[:, 1:])
        return (
            _round(g0 / (fw[0] * self.cell_vol), self.dtype),
            _round(g1 / (fw[1] * self.cell_vol), self.dtype),
        )

    def l1(self, u):
        return self.cell_vol * float(self.density(*u).sum())

    # --------------------------------------------------------------- solve

    def distance(self, src: np.ndarray, dst: np.ndarray):
        src = _round(np.asarray(src, dtype=np.float64), self.dtype)
        dst = _round(np.asarray(dst, dtype=np.float64), self.dtype)
        rhs = self.cell_vol * (dst - src)
        H, W = self.shape
        ones = [np.ones((H - 1, W)), np.ones((H, W - 1))]
        u = self.fluxes(ones, self.pressure(ones, rhs))
        dist = self.l1(u)
        it = 0
        for k in range(self.num_iter):
            fw = self.face_weights(*u)
            u = self.fluxes(fw, self.pressure(fw, rhs))
            d = self.l1(u)
            it = k + 1
            if not np.isfinite(d):
                break
            converged = abs(d - dist) / max(d, 1e-30) < self.tol and k > 1
            dist = d
            if converged:
                break
        return dist, it
