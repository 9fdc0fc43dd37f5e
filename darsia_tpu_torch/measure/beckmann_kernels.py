"""Stencil kernels of the Beckmann problem, on tensors.

Counterpart of :mod:`darsia_tpu.measure.beckmann_kernels`: fluxes live as
per-axis face arrays, divergence and gradient are stencils, and the pressure
Schur complement is a TPFA operator solved by nullspace-projected CG,
preconditioned by Jacobi (:func:`tpfa_cg`) or by one geometric-multigrid
V-cycle (:func:`tpfa_mg_pcg`).

The spatial axes are a tensor's last ``dim`` axes; leading axes (if any)
are a batch that the face arrays broadcast over.  Fixed-count loops (the JAX
package's ``lax.fori_loop``) are Python loops that read nothing on the
host; the CG loops go through :func:`darsia_tpu_torch.ops.solvers.iterate_while`,
which reads the device-computed stopping rule once per iteration.  A CG
solve of a batch of problems (``rhs`` of shape ``(B, *shape)``, the
transmissibilities ``(B, *faces)`` or shared) is what ``jax.vmap`` makes of
the JAX package's loop: each problem stops on its own rule and keeps its
state from then on (:func:`~darsia_tpu_torch.ops.solvers.iterate_while_batched`),
and every launch serves the whole batch.  The
arithmetic of every stencil is the JAX package's, term for term.  The
V-cycle computes the same preconditioner with fewer launches (a CG
iteration at 512^2 is launch-bound: 862 launches, the card idle 90% of the
time, 535 of them the coarsest level's 42 sweeps on 16 x 16 cells): its
smoother forms ``b - A x`` with fused multiply-adds, and a small coarsest
level's sweeps, a fixed linear map, are one float64 matrix product.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.solvers import iterate_while, iterate_while_batched
from ..utils import tracing

__all__ = [
    "face_divergence",
    "pressure_gradient_faces",
    "face_to_cell_pt",
    "transport_density_cells",
    "tpfa_apply",
    "tpfa_cg",
    "tpfa_mg_pcg",
    "tpfa_coarsen_trans",
    "tpfa_mg_levels",
    "harmonic_face_average",
]


def _axis(x: torch.Tensor, d: int, dim: int) -> int:
    """Tensor axis of spatial axis ``d`` (the last ``dim`` axes are space)."""
    return x.dim() - dim + d


def _pad_axis(arr: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    pads = [0, 0] * (arr.dim() - 1 - axis) + [before, after]
    return F.pad(arr, pads)


def _slice_axis(arr: torch.Tensor, axis: int, start: int, stop=None, step: int = 1):
    slicer = [slice(None)] * arr.dim()
    slicer[axis] = slice(start, stop, step)
    return arr[tuple(slicer)]


def face_divergence(fluxes: tuple, face_vol: tuple, dim: int) -> torch.Tensor:
    """Integrated cell divergence of per-axis face fluxes.

    Sign convention of the reference FVDivergence: the cell before a face
    (lower index) receives +face_vol*u, the cell after receives -.  It is
    the transpose of :func:`pressure_gradient_faces`.
    """
    div = None
    for d in range(dim):
        u = fluxes[d]
        ax = _axis(u, d, dim)
        contrib = face_vol[d] * (_pad_axis(u, ax, 0, 1) - _pad_axis(u, ax, 1, 0))
        div = contrib if div is None else div + contrib
    return div


def pressure_gradient_faces(p: torch.Tensor, face_vol: tuple, dim: int) -> tuple:
    """(D^T p) per axis: face value = face_vol * (p_before - p_after)."""
    out = []
    for d in range(dim):
        ax = _axis(p, d, dim)
        n = p.shape[ax]
        out.append(face_vol[d] * (p.narrow(ax, 0, n - 1) - p.narrow(ax, 1, n - 1)))
    return tuple(out)


def face_to_cell_pt(fluxes: tuple, pt: torch.Tensor, shape: tuple, dim: int):
    """RT0 evaluation of the flux at relative point ``pt`` in each cell.

    ``pt`` is ``(dim,)``, or ``(nq, dim)`` for ``nq`` points at once; the
    result is ``(*lead, *shape, dim)``, or ``(nq, *lead, *shape, dim)`` for
    fluxes with leading batch axes ``lead``.
    """
    lead = pt.shape[:-1]
    comps = []
    for d in range(dim):
        u = fluxes[d]
        ax = _axis(u, d, dim)
        w = pt[..., d].reshape(lead + (1,) * u.dim())
        comps.append(w * _pad_axis(u, ax, 0, 1) + (1 - w) * _pad_axis(u, ax, 1, 0))
    return torch.stack(comps, dim=-1)


def face_to_cell_pt_adjoint(cell: torch.Tensor, pt: torch.Tensor, dim: int) -> tuple:
    """Transpose of :func:`face_to_cell_pt` for one point: per axis, the
    adjoint of a zero pad is a slice, so face ``d`` collects
    ``pt_d * cell[before] + (1 - pt_d) * cell[after]`` of component ``d``.

    ``pt`` may be ``(nq, dim)`` with ``cell`` ``(nq, *shape, dim)``: the
    per-point transposes are summed over the points.
    """
    lead = pt.shape[:-1]
    out = []
    for d in range(dim):
        y = cell[..., d]
        ax = _axis(y, d, dim)
        n = y.shape[ax]
        w = pt[..., d].reshape(lead + (1,) * dim)
        face = w * y.narrow(ax, 0, n - 1) + (1 - w) * y.narrow(ax, 1, n - 1)
        out.append(face.sum(dim=0) if lead else face)
    return tuple(out)


def transport_density_cells(
    fluxes: tuple,
    quad_pts: torch.Tensor,
    quad_weights: torch.Tensor,
    cell_weights,
    shape: tuple,
    dim: int,
) -> torch.Tensor:
    """Quadrature of |weight * RT0 flux| over each cell (all quadrature
    points in one batch)."""
    cell_flux = face_to_cell_pt(fluxes, quad_pts, shape, dim)
    if isinstance(cell_weights, torch.Tensor):
        cell_flux = cell_flux * cell_weights[..., None]
    elif cell_weights != 1:
        cell_flux = cell_flux * cell_weights
    norms = torch.linalg.vector_norm(cell_flux, dim=-1)
    return (quad_weights.reshape((-1,) + (1,) * (norms.dim() - 1)) * norms).sum(dim=0)


def harmonic_face_average(cell_qty: torch.Tensor, dim: int) -> tuple:
    """Regularized harmonic mean of a cell quantity on interior faces."""
    out = []
    for d in range(dim):
        ax = _axis(cell_qty, d, dim)
        n = cell_qty.shape[ax]
        a = cell_qty.narrow(ax, 0, n - 1)
        b = cell_qty.narrow(ax, 1, n - 1)
        denom = a + b
        safe = torch.where(denom == 0, torch.ones_like(denom), denom)
        out.append(torch.where(denom > 0, 2.0 * a * b / safe, torch.zeros_like(denom)))
    return tuple(out)


def tpfa_apply(p: torch.Tensor, trans: tuple, dim: int) -> torch.Tensor:
    """Apply the TPFA operator A p = D diag(1/w m) D^T p.

    ``trans[d]`` are per-face transmissibilities (face arrays).
    """
    out = torch.zeros_like(p)
    for d in range(dim):
        ax = _axis(p, d, dim)
        n = p.shape[ax]
        face_flux = trans[d] * (p.narrow(ax, 0, n - 1) - p.narrow(ax, 1, n - 1))
        out.narrow(ax, 0, n - 1).add_(face_flux)
        out.narrow(ax, 1, n - 1).sub_(face_flux)
    return out


def _tpfa_diag(trans: tuple, dim: int) -> torch.Tensor:
    diag = None
    for d in range(dim):
        ax = _axis(trans[d], d, dim)
        contrib = _pad_axis(trans[d], ax, 0, 1) + _pad_axis(trans[d], ax, 1, 0)
        diag = contrib if diag is None else diag + contrib
    return torch.clamp(diag, min=1e-30)


def _cells(x: torch.Tensor, dim: int) -> tuple:
    """The grid axes of ``x``: its last ``dim`` axes."""
    return tuple(range(x.dim() - dim, x.dim()))


def per_pair(v: torch.Tensor, dim: int) -> torch.Tensor:
    """A value per problem of a batch, ``(B,)``, shaped to broadcast against
    ``(B, *shape)``; a 0-d value (one problem) stays as it is."""
    return v if v.dim() == 0 else v.reshape(v.shape + (1,) * dim)


def _vdot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """<a, b> over the grid axes: 0-d, or ``(B,)`` for a batch (one batched
    matrix product, one launch like ``torch.dot``)."""
    if a.dim() == dim:
        return torch.dot(a.reshape(-1), b.reshape(-1))
    n = math.prod(a.shape[a.dim() - dim :])
    lead = a.shape[: a.dim() - dim]
    return torch.bmm(a.reshape(-1, 1, n), b.reshape(-1, n, 1)).reshape(lead)


def _norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    if v.dim() == dim:
        return torch.linalg.vector_norm(v)
    return torch.linalg.vector_norm(v, dim=_cells(v, dim))


def _project(v: torch.Tensor, dim: int) -> torch.Tensor:
    """``v`` minus its mean over the grid (per problem of a batch)."""
    if v.dim() == dim:
        return v - torch.mean(v)
    return v - torch.mean(v, dim=_cells(v, dim), keepdim=True)


def _pcg(A, M, rhs, x0, tol, maxiter, guard_rz_positive: bool, clamp_beta: bool, dim: int,
         active=None):
    """Nullspace-projected preconditioned CG (the JAX package's two CG loops:
    Jacobi-preconditioned with ``rz > 1e-28`` and a clamped beta; MG with
    ``|rz| > 1e-28`` and a plain beta).  Stops on convergence, the iteration
    cap, or float32 breakdown (rz non-finite or underflowing); an update
    that makes x non-finite is rejected (the last healthy iterate stays).

    A batch (``rhs`` with leading axes) runs as ``jax.vmap`` runs the loop:
    every problem stops on its own threshold ``tol * |b|`` and health test
    and keeps its state from then on; ``active`` (a ``(B,)`` bool tensor)
    leaves the problems it marks False at ``x0``'s projection from the
    start.  Launches per iteration do not grow with the batch.  The loop's
    body executions count as ``beckmann.cg_trips`` (read from what the loop
    already returns to the host)."""
    b = _project(rhs, dim)
    x = _project(x0, dim)
    r = b - A(x)
    z = M(r)
    rz = _vdot(r, z, dim)
    threshold = tol * torch.clamp(_norm(b, dim), min=1e-30)

    def cond(state, k):
        _, r, _, rz = state
        small = rz if guard_rz_positive else torch.abs(rz)
        healthy = torch.isfinite(rz) & (small > 1e-28)
        return (_norm(r, dim) > threshold) & healthy

    def body(state, k):
        x, r, pvec, rz = state
        Ap = A(pvec)
        alpha = per_pair(rz / torch.clamp(_vdot(pvec, Ap, dim), min=1e-30), dim)
        x_new = _project(x + alpha * pvec, dim)
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = _vdot(r_new, z, dim)
        beta = per_pair(rz_new / (torch.clamp(rz, min=1e-30) if clamp_beta else rz), dim)
        pvec_new = z + beta * pvec
        ok = per_pair(torch.isfinite(_vdot(x_new, x_new, dim)), dim)
        x_new = torch.where(ok, x_new, x)
        r_new = torch.where(ok, r_new, r)
        return (x_new, r_new, pvec_new, rz_new)

    if rhs.dim() == dim:
        (x, *_), trips = iterate_while(cond, body, (x, r, z, rz), maxiter)
    else:
        (x, *_), counts = iterate_while_batched(cond, body, (x, r, z, rz), maxiter, active)
        trips = int(counts.max()) if counts.size else 0
    tracing.count("beckmann.cg_trips", trips)
    return x


def tpfa_cg(
    trans: tuple,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    dim: int = 2,
    tol: float = 1e-6,
    maxiter: int = 500,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nullspace-projected, Jacobi-preconditioned CG for the TPFA system.

    The pure-Neumann TPFA operator has the constants as nullspace; rhs and
    iterates are orthogonalized against constants (the reference's
    Lagrange-multiplier pressure constraint, SPD-friendly).  ``rhs`` may
    carry a leading batch axis (see :func:`_pcg`; ``active`` masks it).
    """
    diag = torch.zeros_like(rhs)
    for d in range(dim):
        ax = _axis(trans[d], d, dim)
        diag = diag + _pad_axis(trans[d], ax, 0, 1) + _pad_axis(trans[d], ax, 1, 0)
    diag = torch.clamp(diag, min=1e-30)
    return _pcg(
        lambda p: tpfa_apply(p, trans, dim),
        lambda r: _project(r / diag, dim),
        rhs,
        x0,
        tol,
        maxiter,
        guard_rz_positive=True,
        clamp_beta=True,
        dim=dim,
        active=active,
    )


# --------------------------------------------------------------------------
# Geometric multigrid preconditioner for the TPFA system.
#
# Cells aggregate in 2^dim blocks; the coarse operator is the exact Galerkin
# product P^T A P (for piecewise-constant prolongation P the TPFA operator
# coarsens to a TPFA operator whose coarse face transmissibility is the sum
# of the fine faces crossing the aggregate boundary); the smoother is damped
# Jacobi, self-adjoint in the A-inner product, so the V-cycle is an SPD
# preconditioner safe for CG.
# --------------------------------------------------------------------------


def _pair_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum adjacent pairs along ``axis`` (odd tail aggregates alone)."""
    if x.shape[axis] % 2:
        x = _pad_axis(x, axis, 0, 1)
    return _slice_axis(x, axis, 0, None, 2) + _slice_axis(x, axis, 1, None, 2)


def tpfa_coarsen_trans(trans: tuple, dim: int) -> tuple:
    """Galerkin (P^T A P) coarse transmissibilities for 2x aggregation.

    The coarse face between aggregates I and I+1 along axis ``d`` collects
    the fine faces at odd index 2I+1 along ``d``, summed over the (up to)
    2^(dim-1) transverse fine positions inside the aggregate.
    """
    out = []
    for d in range(dim):
        t = trans[d]
        t = _slice_axis(t, _axis(t, d, dim), 1, None, 2)
        for e in range(dim):
            if e != d:
                t = _pair_sum(t, _axis(t, e, dim))
        out.append(t)
    return tuple(out)


def _restrict_cells(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Aggregate-sum restriction R = P^T (piecewise-constant P)."""
    for d in range(dim):
        x = _pair_sum(x, _axis(x, d, dim))
    return x


def _prolong_cells(x: torch.Tensor, fine_shape: tuple, dim: int) -> torch.Tensor:
    """Piecewise-constant prolongation (each aggregate's value to its cells):
    one copy for all axes (a broadcast and a reshape), then a view that
    drops the odd tails."""
    lead = tuple(x.shape[: x.dim() - dim])
    coarse = tuple(x.shape[x.dim() - dim :])
    view = lead + sum(((c, 1) for c in coarse), ())
    wide = lead + sum(((c, 2) for c in coarse), ())
    x = x.reshape(view).expand(wide).reshape(lead + tuple(2 * c for c in coarse))
    return x[(Ellipsis,) + tuple(slice(0, s) for s in fine_shape[-dim:])]


#: The coarsest level's sweeps become one matrix product when it has at
#: most this many cells (16 x 16 at 512^2, 4^3 at 64^3: 810 -> ~190 launches
#: per V-cycle at 512^2, where 535 were its 42 sweeps).
COARSE_MATRIX_CELLS = 1024


class MGHierarchy(NamedTuple):
    """Per level: face transmissibilities and the Jacobi step omega/diag;
    ``coarse``: the (n, n) float64 matrix of the coarsest level's sweeps
    from zero (row i = the sweeps applied to unit vector i), ``(B, n, n)``
    for transmissibilities with a batch axis, or None."""

    trans: list
    steps: list
    coarse: Optional[torch.Tensor]


def _tpfa_residual(x: torch.Tensor, b: torch.Tensor, trans: tuple, dim: int) -> torch.Tensor:
    """b - A x in one copy and two fused multiply-adds per axis (the same
    sums as ``b - tpfa_apply(x)``, in another order)."""
    r = b.clone()
    for d in range(dim):
        ax = _axis(x, d, dim)
        n = x.shape[ax]
        diff = x.narrow(ax, 0, n - 1) - x.narrow(ax, 1, n - 1)
        r.narrow(ax, 0, n - 1).addcmul_(trans[d], diff, value=-1)
        r.narrow(ax, 1, n - 1).addcmul_(trans[d], diff)
    return r


def _tpfa_sweeps(x, b, trans, step, dim, nu):
    """``nu`` damped Jacobi sweeps ``x <- x + step * (b - A x)`` with
    ``step = omega / diag``; ``x=None`` starts from zero."""
    for _ in range(nu):
        if x is None:
            x = b * step
        else:
            x = torch.addcmul(x, _tpfa_residual(x, b, trans, dim), step)
    return torch.zeros_like(b) if x is None else x


def _tpfa_coarsest(b, hierarchy: MGHierarchy, dim, nu, nu_coarse):
    """The coarsest level: ``nu + nu_coarse`` sweeps from zero, a linear map
    of ``b`` (applied as its float64 matrix when there is one; per problem
    of a batch, one batched product)."""
    if hierarchy.coarse is not None:
        lead = tuple(b.shape[: b.dim() - dim])
        flat = torch.matmul(b.reshape(lead + (1, -1)).to(torch.float64), hierarchy.coarse)
        return flat.reshape(b.shape).to(b.dtype)
    trans, step = hierarchy.trans[-1], hierarchy.steps[-1]
    return _tpfa_sweeps(_tpfa_sweeps(None, b, trans, step, dim, nu), b, trans, step, dim, nu_coarse)


def _tpfa_vcycle(b, hierarchy: MGHierarchy, dim, nu, nu_coarse, level=0):
    if level == len(hierarchy.trans) - 1:
        return _tpfa_coarsest(b, hierarchy, dim, nu, nu_coarse)
    trans, step = hierarchy.trans[level], hierarchy.steps[level]
    x = _tpfa_sweeps(None, b, trans, step, dim, nu)
    rc = _restrict_cells(_tpfa_residual(x, b, trans, dim), dim)
    ec = _tpfa_vcycle(rc, hierarchy, dim, nu, nu_coarse, level + 1)
    x = x + _prolong_cells(ec, tuple(b.shape), dim)
    return _tpfa_sweeps(x, b, trans, step, dim, nu)


def tpfa_mg_levels(shape: tuple, max_levels: int = 6, coarsest: int = 4) -> int:
    """Static level count: halve until the smallest axis reaches ``coarsest``."""
    levels = 1
    sizes = [int(s) for s in shape]
    while levels < max_levels and min(sizes) >= 2 * coarsest:
        sizes = [(s + 1) // 2 for s in sizes]
        levels += 1
    return levels


def tpfa_mg_hierarchy(
    trans: tuple, dim: int, levels: int, nu: int = 2, nu_coarse: int = 40, omega: float = 0.8
) -> MGHierarchy:
    """The V-cycle's levels: Galerkin-coarsened transmissibilities, Jacobi
    steps and (for a small coarsest level) the matrix of its sweeps, built in
    float64 on the unit vectors as one batch (for a batch of problems, B * n
    unit vectors: one matrix per problem)."""
    trans_levels = [tuple(trans)]
    for _ in range(levels - 1):
        trans_levels.append(tpfa_coarsen_trans(trans_levels[-1], dim))
    steps = [omega / _tpfa_diag(t, dim) for t in trans_levels]
    coarse = None
    lead = tuple(steps[-1].shape[: steps[-1].dim() - dim])
    shape = tuple(steps[-1].shape[steps[-1].dim() - dim :])
    n = math.prod(shape)
    if n <= COARSE_MATRIX_CELLS:
        t64 = tuple(t.to(torch.float64) for t in trans_levels[-1])
        eye = torch.eye(n, dtype=torch.float64, device=steps[-1].device)
        if lead:
            eye = eye.reshape((n,) + (1,) * len(lead) + shape).expand((n,) + lead + shape)
            eye = eye.contiguous()
        else:
            eye = eye.reshape((n,) + shape)
        sweeps = _tpfa_sweeps(None, eye, t64, omega / _tpfa_diag(t64, dim), dim, nu + nu_coarse)
        coarse = sweeps.reshape((n,) + lead + (n,))
        if lead:
            coarse = coarse.movedim(0, -2)
    return MGHierarchy(trans_levels, steps, coarse)


def tpfa_mg_pcg(
    trans: tuple,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    dim: int = 2,
    tol: float = 1e-6,
    maxiter: int = 200,
    levels: int = 4,
    nu: int = 2,
    nu_coarse: int = 40,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nullspace-projected CG preconditioned by one geometric-MG V-cycle.

    On heterogeneous 1/|u| mobility weights the Jacobi-preconditioned
    :func:`tpfa_cg` iteration count grows with grid size and weight
    contrast; the Galerkin V-cycle keeps it roughly grid-independent.
    ``rhs`` may carry a leading batch axis (see :func:`_pcg`; ``active``
    masks it), the transmissibilities too (one hierarchy per problem).
    """
    hierarchy = tpfa_mg_hierarchy(trans, dim, levels, nu, nu_coarse)
    return _pcg(
        lambda p: tpfa_apply(p, hierarchy.trans[0], dim),
        lambda r: _project(_tpfa_vcycle(r, hierarchy, dim, nu, nu_coarse), dim),
        rhs,
        x0,
        tol,
        maxiter,
        guard_rz_positive=False,
        clamp_beta=False,
        dim=dim,
        active=active,
    )
