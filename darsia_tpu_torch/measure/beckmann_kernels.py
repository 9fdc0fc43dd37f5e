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

On the card, a 2D float32 :func:`tpfa_mg_pcg` runs its CG trips through the
hand-written kernels of ``csrc/tpfa_mg.cu`` (:class:`FusedMGPCG`): each
V-cycle level is two fused passes, the CG update three, about 25 fine-field
passes a trip where the tensor form streams about 224.  The same class holds
their plain PyTorch mirror, step for step, for the tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_build
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
    already returns to the host), and none of them as a trip of the
    kernels: ``beckmann.mg_kernel_trips`` gets 0, so that a trace shows it."""
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
    tracing.count("beckmann.mg_kernel_trips", 0)
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


def _mg_levels(trans: tuple, dim: int, levels: int, omega: float) -> tuple:
    """The Galerkin-coarsened transmissibilities of every level and their
    Jacobi steps omega / diag."""
    trans_levels = [tuple(trans)]
    for _ in range(levels - 1):
        trans_levels.append(tpfa_coarsen_trans(trans_levels[-1], dim))
    return trans_levels, [omega / _tpfa_diag(t, dim) for t in trans_levels]


def tpfa_mg_hierarchy(
    trans: tuple, dim: int, levels: int, nu: int = 2, nu_coarse: int = 40, omega: float = 0.8
) -> MGHierarchy:
    """The V-cycle's levels: Galerkin-coarsened transmissibilities, Jacobi
    steps and (for a small coarsest level) the matrix of its sweeps, built in
    float64 on the unit vectors as one batch (for a batch of problems, B * n
    unit vectors: one matrix per problem)."""
    trans_levels, steps = _mg_levels(trans, dim, levels, omega)
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

    A 2D float32 problem on a CUDA device with at least two levels runs
    :func:`mg_pcg_fused` on :func:`mg_hierarchy_on_card` (the kernels of
    ``csrc/tpfa_mg.cu``; its trips count as ``beckmann.cg_trips`` and
    ``beckmann.mg_kernel_trips``); any other runs the tensor code.
    """
    if dim == 2 and rhs.is_cuda and rhs.dtype == torch.float32 and levels > 1:
        hierarchy = mg_hierarchy_on_card(trans, levels, nu, nu_coarse)
        x, counts = mg_pcg_fused(hierarchy, rhs, x0, tol, maxiter, nu, nu_coarse, active)
        trips = int(counts.max()) if counts.size else 0
        tracing.count("beckmann.cg_trips", trips)
        tracing.count("beckmann.mg_kernel_trips", trips)
        return x
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


# --------------------------------------------------------------------------
# The CG trip in hand-written kernels (2D, float32): ``csrc/tpfa_mg.cu``.
#
# One trip: A p with <p, A p> (1 launch), the x and r update (1), the V-cycle
# (per level above the coarsest a pre-smoothing + residual + restriction pass
# and a correction + post-smoothing pass on the pre-smoothed x; the coarsest
# level's float64 matrix product), the new direction (1) and the per-pair
# scalars with the stopping rule (1); the host reads the (B,) flags once a
# trip, as :func:`~darsia_tpu_torch.ops.solvers.iterate_while_batched` does.
# The arithmetic is :func:`_pcg`'s with the MG preconditioner, in another
# order where fusion asks for it: x is stored unprojected, its mean
# subtracted when it is next read; <r, z - mean z> is <r, z> - mean z * sum r
# from the V-cycle's last pass; per-pair sums are float64 over per-block
# float32 partials.  x and r live in two buffers per pair, so that an update
# whose x is not finite is rejected as _pcg rejects it.
# --------------------------------------------------------------------------

#: The damped Jacobi weight of the kernels' smoother (tpfa_mg_hierarchy's
#: default, which tpfa_mg_pcg uses).
_OMEGA = 0.8


_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The C entry points of ``csrc/tpfa_mg.cu`` and their argument types, in
#: the order of its C signatures (the last argument is the stream).
_ENTRIES = {
    "darsia_tpfa_apply": [_PTR] * 3 + [_INT] + [_PTR] * 3 + [_INT] * 4 + [_PTR],
    "darsia_cg_update": [_PTR] * 6 + [_INT] + [_PTR] * 4 + [_INT] * 3 + [_PTR],
    "darsia_mg_pre": [_PTR] * 2 + [_INT] + [_PTR] * 2 + [_INT] + [_PTR] * 3 + [_INT] * 9
    + [_FLT, _PTR],
    "darsia_mg_post": [_PTR] * 2 + [_INT] + [_PTR] * 2 + [_INT] + [_PTR] * 3 + [_INT]
    + [_PTR] * 2 + [_INT] * 8 + [_FLT, _PTR],
    "darsia_cg_direction": [_PTR] * 3 + [_INT] + [_PTR] * 3 + [_INT] * 3 + [_PTR],
    "darsia_cg_finalize": [_PTR] * 8 + [_INT] * 3 + [_PTR],
    "darsia_mg_coarse_matrix": [_PTR] * 2 + [_INT, _PTR] + [_INT] * 4 + [ctypes.c_double, _PTR],
}


@functools.lru_cache(maxsize=None)
def build_kernels() -> dict:
    """Compile (once per version of the source) and load
    ``csrc/tpfa_mg.cu``, in the span ``beckmann.build``; its C entry points
    by name."""
    return cuda_build.load({"tpfa_mg": _ENTRIES}, "beckmann.build")


def _launch_kernel(name: str, args: tuple, stream: int) -> None:
    """Launch C entry ``name`` of ``csrc/tpfa_mg.cu`` on ``stream``; raise on
    its error.  Counted as ``beckmann.mg_launches``."""
    err = build_kernels()[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    tracing.count("beckmann.mg_launches")


def mg_hierarchy_on_card(trans: tuple, levels: int, nu: int = 2, nu_coarse: int = 40
                         ) -> MGHierarchy:
    """:func:`tpfa_mg_hierarchy` of 2D float32 transmissibilities on a CUDA
    device, the coarsest level's matrix (its ``nu + nu_coarse`` sweeps on
    each unit vector, float64) built by one kernel where the tensor form
    takes about 400 launches on tiny arrays; the same matrix up to float64
    rounding."""
    trans_levels, steps = _mg_levels(trans, 2, levels, _OMEGA)
    h, w = steps[-1].shape[-2:]
    if h * w > COARSE_MATRIX_CELLS:
        return MGHierarchy(trans_levels, steps, None)
    return MGHierarchy(trans_levels, steps, mg_coarse_matrix(trans_levels[-1], nu + nu_coarse))


def mg_coarse_matrix(trans: tuple, sweeps: int) -> torch.Tensor:
    """The float64 matrix of ``sweeps`` damped Jacobi sweeps from zero on
    the 2D float32 transmissibilities ``trans`` of a CUDA device (row i: the
    sweeps applied to unit vector i), ``(n, n)``, or ``(B, n, n)`` for faces
    with a batch axis; one launch."""
    t0, t1 = (t.contiguous() for t in trans)
    lead = tuple(t0.shape[:-2])
    h, w = t0.shape[-2] + 1, t0.shape[-1]
    coarse = torch.empty(lead + (h * w, h * w), dtype=torch.float64, device=t0.device)
    with torch.cuda.device(t0.device):
        _launch_kernel("darsia_mg_coarse_matrix", (
            t0.data_ptr(), t1.data_ptr(), int(not lead), coarse.data_ptr(),
            lead[0] if lead else 1, h, w, sweeps, _OMEGA,
        ), torch.cuda.current_stream(t0.device).cuda_stream)
    return coarse


#: Most cells of a V-cycle tile with its halo: six float32 arrays of them in
#: shared memory, 37 KB, so that six blocks share an SM (on the card, six
#: blocks of 1440-cell tiles beat four of 2048-cell ones at the finest level
#: of the W1 benchmark's grid).
_TILE_CELLS = 1536


@functools.lru_cache(maxsize=None)
def _mg_tile(h: int, w: int, halo: int) -> tuple:
    """``(TH, TW, tiles_h, tiles_w)``: the even tile whose tiles of an
    ``(h, w)`` level, each with its halo, keep the kernels' 32 x 8 threads
    busiest: the fewest thread slots (region rows rounded up to 8, columns
    to 32) over all tiles, a block's fixed cost (its loads' latency, its
    barriers) counted as 256."""
    best = None
    for th in range(2, min(64, h + h % 2) + 1, 2):
        for tw in range(2, min(256, w + w % 2) + 1, 2):
            rh, rw = th + 2 * halo, tw + 2 * halo
            if rh * rw > _TILE_CELLS:
                break
            nh, nw = -(-h // th), -(-w // tw)
            cost = nh * nw * (-(-rh // 8) * 8 * -(-rw // 32) * 32 + 256)
            if best is None or cost < best[0]:
                best = (cost, th, tw, nh, nw)
    if best is None:
        raise ValueError(f"no V-cycle tile fits a halo of {halo} cells")
    return best[1:]


def _blocks(n: int) -> int:
    """Blocks per pair of a pointwise kernel (256 threads, ~4 cells each)."""
    return min(512, max(1, -(-n // 1024)))


class FusedMGPCG:
    """State and steps of the kernels' CG for a batch of ``B`` 2D problems
    on one hierarchy (:func:`tpfa_mg_hierarchy`, per-pair or shared
    transmissibilities), with their plain PyTorch mirror.

    ``kernels=True`` launches ``csrc/tpfa_mg.cu`` (CUDA tensors);
    ``kernels=False`` computes each step with tensor operations on the same
    buffers, in the kernels' order of operations (the V-cycle as
    :func:`_tpfa_vcycle`, whose values the fused passes reproduce), on any
    device.  Buffers: ``X``, ``R`` ``(2, B, h, w)`` (pair b's iterate in
    buffer ``sel[b]``, stored unprojected with mean ``mx[b]``), ``P``,
    ``AP``, ``Z`` ``(B, h, w)``; per pair ``rz``, ``rn`` (|r|), ``thr`` (the
    stopping threshold), ``act`` (uint8: the pair still iterates); float64
    partial sums ``part_a`` (<p, A p>), ``part_u`` (sum x, |x|^2, |r|^2 of
    the update), ``part_v`` (sum z, <r, z>, sum r of the V-cycle).
    """

    def __init__(self, hierarchy: MGHierarchy, B: int, shape: tuple, nu: int, nu_coarse: int,
                 kernels: bool = True) -> None:
        self.hierarchy, self.nu, self.nu_coarse, self.kernels = hierarchy, nu, nu_coarse, kernels
        self.B, (self.h, self.w) = B, shape
        self.n = self.h * self.w
        self.trans = [tuple(t.contiguous() for t in level) for level in hierarchy.trans]
        for t0, t1 in self.trans:
            if t0.dim() == 3 and t0.shape[0] != B:
                raise ValueError(f"transmissibilities for {t0.shape[0]} problems, {B} given")
        self.shared = int(self.trans[0][0].dim() == 2)
        dev = self.trans[0][0].device
        if kernels and (dev.type != "cuda" or self.trans[0][0].dtype != torch.float32
                        or B > 65535):
            raise ValueError("the CG-trip kernels take float32 CUDA tensors and at most 65535 "
                             f"problems; got {self.trans[0][0].dtype} on {dev}, {B} problems")
        f32 = dict(dtype=torch.float32, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        field = (B, self.h, self.w)
        self.X, self.R = torch.zeros((2,) + field, **f32), torch.zeros((2,) + field, **f32)
        self.P, self.AP, self.Z = (torch.zeros(field, **f32) for _ in range(3))
        self.sel = torch.zeros(B, dtype=torch.int32, device=dev)
        self.mx, self.rn, self.rz, self.rz_next, self.thr = (torch.zeros(B, **f32) for _ in range(5))
        self.act = torch.ones(B, dtype=torch.uint8, device=dev)
        self.nblk = _blocks(self.n)
        self.shapes = [tuple(s.shape[-2:]) for s in hierarchy.steps]
        post0 = _mg_tile(self.h, self.w, nu)
        self.part_a = torch.zeros((B, self.nblk), **f64)
        self.part_u = torch.zeros((B, self.nblk, 3), **f64)
        self.part_v = torch.zeros((B, post0[2] * post0[3], 3), **f64)
        self._ar = torch.arange(B, device=dev)
        if kernels:
            self._plan_launches(f32, f64)

    # ------------------------------------------------------------ set-up

    def start(self, rhs: torch.Tensor, x0: torch.Tensor, tol: float,
              active: Optional[torch.Tensor] = None) -> None:
        """The projected start, its residual and preconditioned residual,
        the first direction, and the stopping rule on them (``active``
        holds some pairs still from the start)."""
        b, x = _project(rhs, 2), _project(x0, 2)
        r = b - tpfa_apply(x, self.trans[0], 2)
        self.X[0].copy_(x)
        self.R[0].copy_(r)
        self.sel.zero_()
        self.mx.zero_()
        self.thr.copy_(tol * torch.clamp(_norm(b, 2), min=1e-30))
        self.act.fill_(1)
        self.vcycle(flip=0)
        s = self.part_v.sum(dim=1)
        zbar = (s[:, 0] / self.n).float()
        self.rz.copy_((s[:, 1] - zbar.double() * s[:, 2]).float())
        self.P.copy_(self.Z - zbar[:, None, None])
        self.rn.copy_(_norm(r, 2))
        go = (self.rn > self.thr) & torch.isfinite(self.rz) & (torch.abs(self.rz) > 1e-28)
        if active is not None:
            go = go & active.to(go.device)
        self.act.copy_(go)

    def run(self, maxiter: int) -> tuple:
        """Trips until no pair is active or ``maxiter``; returns the
        projected solution ``(B, h, w)`` and each pair's trips (numpy)."""
        counts = np.zeros(self.B, np.int64)
        for _ in range(maxiter):
            flags = self.act.cpu().numpy().astype(bool)
            if not flags.any():
                break
            counts += flags
            self.trip()
        return self.X[self.sel.long(), self._ar] - self.mx[:, None, None], counts

    def trip(self) -> None:
        self.apply()
        self.update()
        self.vcycle(flip=1)
        self.direction()
        self.finalize()

    # ------------------------------------------------------------ the steps

    def _active(self) -> torch.Tensor:
        return self.act.bool()

    def apply(self) -> None:
        """``AP = A P`` and ``part_a``: <p, A p> per pair."""
        if self.kernels:
            return self._launch(*self._apply)
        a = self._active()
        ap = tpfa_apply(self.P, self.trans[0], 2)
        self.AP[a] = ap[a]
        self.part_a[a, 0] = (self.P * ap).double().sum(dim=(1, 2))[a]

    def update(self) -> None:
        """``x <- (x - mx) + alpha p``, ``r <- r - alpha A p`` into the other
        buffer, alpha = rz / <p, A p>; ``part_u``."""
        if self.kernels:
            return self._launch(*self._update)
        a, ar = self._active(), self._ar
        pap = self.part_a.sum(dim=1).float()
        alpha = (self.rz / torch.clamp(pap, min=1e-30))[:, None, None]
        src = self.sel.long()
        xn = (self.X[src, ar] - self.mx[:, None, None]) + alpha * self.P
        rn = self.R[src, ar] - alpha * self.AP
        dst = 1 - src
        self.X[dst[a], ar[a]] = xn[a]
        self.R[dst[a], ar[a]] = rn[a]
        sums = [xn.double(), (xn * xn).double(), (rn * rn).double()]
        self.part_u[a, 0] = torch.stack([v.sum(dim=(1, 2)) for v in sums], dim=-1)[a]

    def vcycle(self, flip: int) -> None:
        """``Z`` = the V-cycle of ``R[sel ^ flip]`` (unprojected) and
        ``part_v``: sum z, <r, z>, sum r per pair."""
        if self.kernels:
            for l in range(len(self.trans) - 1):
                self._launch(*self._pre[l][flip if l == 0 else 0])
            self._coarsest()
            for l in reversed(range(len(self.trans) - 1)):
                self._launch(*self._post[l][flip if l == 0 else 0])
            return
        a = self._active()
        b = self.R[self.sel.long() ^ flip, self._ar]
        z = _tpfa_vcycle(b, self.hierarchy, 2, self.nu, self.nu_coarse)
        self.Z[a] = z[a]
        sums = [z.double(), (b * z).double(), b.double()]
        self.part_v[a, 0] = torch.stack([v.sum(dim=(1, 2)) for v in sums], dim=-1)[a]

    def direction(self) -> None:
        """``P <- (Z - mean Z) + beta P``, beta = rz_next / rz, rz_next =
        <r, Z - mean Z>."""
        if self.kernels:
            return self._launch(*self._direction)
        a = self._active()
        s = self.part_v.sum(dim=1)
        zbar = (s[:, 0] / self.n).float()
        rzn = (s[:, 1] - zbar.double() * s[:, 2]).float()
        beta = rzn / self.rz
        p = (self.Z - zbar[:, None, None]) + beta[:, None, None] * self.P
        self.P[a] = p[a]
        self.rz_next[a] = rzn[a]

    def finalize(self) -> None:
        """Per active pair: keep the update if its x is finite (flip
        ``sel``, new ``mx`` and ``rn``), take ``rz_next``, and apply the
        stopping rule to ``act``."""
        if self.kernels:
            return self._launch(*self._finalize)
        a = self._active()
        s = self.part_u.sum(dim=1)
        ok = a & torch.isfinite(s[:, 1].float())
        self.sel.copy_(torch.where(ok, 1 - self.sel, self.sel))
        self.mx.copy_(torch.where(ok, (s[:, 0] / self.n).float(), self.mx))
        self.rn.copy_(torch.where(ok, torch.sqrt(s[:, 2]).float(), self.rn))
        self.rz.copy_(torch.where(a, self.rz_next, self.rz))
        go = (self.rn > self.thr) & torch.isfinite(self.rz) & (torch.abs(self.rz) > 1e-28)
        self.act.copy_(a & go)

    # ------------------------------------------------------------ launches

    def _plan_launches(self, f32: dict, f64: dict) -> None:
        """Every launch's arguments, once per solve (the buffers stay)."""
        B, L, nu = self.B, len(self.trans), self.nu
        self._stream = torch.cuda.current_stream(self.X.device).cuda_stream
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        act = ptr(self.act)
        coarse = self.hierarchy.coarse
        # Level l's input (the right-hand side) and output; the coarsest
        # level's are float64 for its matrix.
        wide = f64 if coarse is not None else f32
        self.rc = [None] + [torch.zeros((B,) + s, **(wide if l == L - 1 else f32))
                            for l, s in enumerate(self.shapes) if l > 0]
        self.zl = [self.Z] + [torch.zeros((B,) + s, **(wide if l == L - 1 else f32))
                              for l, s in enumerate(self.shapes) if l > 0]
        # Each level's pre-smoothed x, kept for its post pass.
        self.xs = [torch.zeros((B,) + s, **f32) for s in self.shapes[:-1]]
        self._pre, self._post = [], []
        for l in range(L - 1):
            (h, w), (t0, t1) = self.shapes[l], self.trans[l]
            common = (int(t0.dim() == 2), act)
            pre_tile, post_tile = _mg_tile(h, w, max(nu, 1)), _mg_tile(h, w, nu)
            last = l + 1 == L - 1
            pres, posts = [], []
            for flip in (0, 1):
                src = (ptr(self.R), ptr(self.sel), flip) if l == 0 else (ptr(self.rc[l]), None, 0)
                pres.append(("darsia_mg_pre", src + (ptr(t0), ptr(t1)) + common + (
                    ptr(self.xs[l]), ptr(self.rc[l + 1]), int(last and coarse is not None), B, h,
                    w, *pre_tile, nu, _OMEGA)))
                ec = self.zl[l + 1]
                posts.append(("darsia_mg_post", src + (ptr(t0), ptr(t1)) + common + (
                    ptr(self.xs[l]), ptr(ec), int(ec.dtype == torch.float64), ptr(self.zl[l]),
                    ptr(self.part_v) if l == 0 else None, B, h, w, *post_tile, nu, _OMEGA)))
            self._pre.append(pres)
            self._post.append(posts)
        t0, t1 = self.trans[0]
        n, nb = self.n, self.nblk
        self._apply = ("darsia_tpfa_apply", (ptr(self.P), ptr(t0), ptr(t1), self.shared, act,
                                             ptr(self.AP), ptr(self.part_a), B, self.h, self.w, nb))
        self._update = ("darsia_cg_update", (
            ptr(self.X), ptr(self.R), ptr(self.sel), ptr(self.P), ptr(self.AP), ptr(self.part_a),
            nb, ptr(self.rz), ptr(self.mx), act, ptr(self.part_u), B, n, nb))
        self._direction = ("darsia_cg_direction", (
            ptr(self.Z), ptr(self.P), ptr(self.part_v), self.part_v.shape[1], ptr(self.rz),
            ptr(self.rz_next), act, B, n, nb))
        self._finalize = ("darsia_cg_finalize", (
            ptr(self.sel), ptr(self.mx), ptr(self.rn), ptr(self.rz), ptr(self.rz_next),
            ptr(self.thr), act, ptr(self.part_u), nb, B, n))

    def _coarsest(self) -> None:
        """The coarsest level: its float64 matrix applied to ``rc[-1]`` (one
        matrix product into ``zl[-1]``), or its sweeps."""
        rc, out, coarse = self.rc[-1], self.zl[-1], self.hierarchy.coarse
        if coarse is None:
            out.copy_(_tpfa_coarsest(rc, self.hierarchy, 2, self.nu, self.nu_coarse))
        elif coarse.dim() == 2:
            torch.mm(rc.view(self.B, -1), coarse, out=out.view(self.B, -1))
        else:
            torch.bmm(rc.view(self.B, 1, -1), coarse, out=out.view(self.B, 1, -1))

    def _launch(self, name: str, args: tuple) -> None:
        _launch_kernel(name, args, self._stream)


def mg_pcg_fused(hierarchy: MGHierarchy, rhs: torch.Tensor, x0: torch.Tensor, tol: float,
                 maxiter: int, nu: int = 2, nu_coarse: int = 40,
                 active: Optional[torch.Tensor] = None, kernels: bool = True) -> tuple:
    """:func:`_pcg` with the V-cycle preconditioner as :class:`FusedMGPCG`
    runs it: the kernels (``kernels=True``, CUDA tensors) or their plain
    mirror.  ``rhs`` is ``(h, w)`` or ``(B, h, w)``; returns the solution in
    ``rhs``'s shape and each pair's trips (a ``(B,)`` numpy array)."""
    single = rhs.dim() == 2
    if single:
        rhs, x0 = rhs[None], x0[None]
    with torch.cuda.device(rhs.device) if kernels else contextlib.nullcontext():
        solver = FusedMGPCG(hierarchy, rhs.shape[0], tuple(rhs.shape[1:]), nu, nu_coarse, kernels)
        solver.start(rhs, x0, tol, active)
        x, counts = solver.run(maxiter)
    return (x[0] if single else x), counts
