"""Sharded TPFA Poisson solves: domain-decomposed Beckmann pressure systems.

Counterpart of :mod:`darsia_tpu.parallel.tpfa`.  The TPFA operator and its
nullspace-projected Jacobi-CG run over a line of row shards: each position
owns a contiguous row block, a matrix-vector product exchanges one halo row
(:func:`~darsia_tpu_torch.parallel.halo.halo_exchange`), and the CG's dot
products and projections are
:func:`~darsia_tpu_torch.parallel.collectives.psum_totals` reductions.  The
vector updates are ``torch._foreach_*`` ops over each device's shards (on a
mesh that names one card several times, one launch for all its shards).
The loop reads one stopping flag per iteration for all shards together
(:func:`darsia_tpu_torch.ops.solvers.iterate_while`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.solvers import iterate_while
from .collectives import broadcast, device_groups, psum_totals, shift
from .halo import halo_exchange
from .mesh import Mesh, Placement

__all__ = ["local_tpfa_operator", "projected_pcg_local", "sharded_tpfa_cg"]


def _by_device(fn, *lines) -> list:
    """``fn(*group_lists, first)`` for each device's positions (``first``:
    the group's first position), the results put back in position order:
    a ``torch._foreach_*`` op then runs once per device over its shards."""
    out = [None] * len(lines[0])
    for idx in device_groups(lines[0]):
        for i, r in zip(idx, fn(*[[line[i] for i in idx] for line in lines], idx[0])):
            out[i] = r
    return out


def _axpy(xs: list, scalars: list, ps: list, sign: float = 1.0) -> list:
    """``x + sign * a * p`` per position; ``scalars`` holds the replicated
    0-d ``a`` per position."""
    return _by_device(
        lambda x, p, i: torch._foreach_add(x, torch._foreach_mul(p, scalars[i]), alpha=sign), xs, ps
    )


def _minus(xs: list, scalars: list, k: int, ones: list) -> list:
    """``x - s[k]`` per position; ``scalars`` holds the replicated vector
    ``s`` per position, ``ones`` a ones tensor per position (a foreach sum
    with a tensor scalar would read it on the host)."""
    return _by_device(
        lambda x, o, i: torch._foreach_sub(x, torch._foreach_mul(o, scalars[i][k])), xs, ones
    )


def _mul(xs: list, ys: list) -> list:
    return _by_device(lambda x, y, i: torch._foreach_mul(x, y), xs, ys)


def projected_pcg_local(
    A: Callable[[list], list],
    diag: list,
    rhs: list,
    tol: float,
    maxiter: int,
    M: Optional[Callable[[list], list]] = None,
) -> list:
    """Nullspace-projected PCG on a line of shards.

    ``A`` maps a line of blocks to a line of blocks (it does its own halo
    exchanges); ``diag`` is its diagonal for the default Jacobi
    preconditioner, which ``M`` (a linear SPD map of lines) overrides.  The
    dot products and totals are :func:`psum_totals` reductions (independent
    ones fused into one), the scalar recurrences run once on the line's
    first device, the vector updates are ``torch._foreach_*`` ops over each
    device's shards, and the loop reads one flag per iteration.  Returns
    the mean-zero solution blocks.
    """
    if M is None:
        def M(r):  # noqa: E306 - default Jacobi
            return _by_device(lambda x, d, i: torch._foreach_div(x, d), r, diag)
    n_total = float(sum(r.numel() for r in rhs))
    ones = [torch.ones_like(v) for v in rhs]

    def project(line):
        return _minus(line, psum_totals([line], then=lambda t: t / n_total), 0, ones)

    b = project(rhs)
    x = [torch.zeros_like(v) for v in b]
    r = _by_device(lambda u, v, i: torch._foreach_sub(u, v), b, A(x))
    z = project(M(r))
    first = psum_totals([_mul(r, z), _mul(r, r), _mul(b, b)])[0]
    rz, rr = first[0], first[1]
    b_norm = torch.sqrt(torch.clamp(first[2], min=1e-30))

    def cond(state, k):
        _, _, _, rz, rr = state
        healthy = torch.isfinite(rz) & (rz > 1e-28)
        return (torch.sqrt(rr) > tol * b_norm) & healthy

    def body(state, k):
        x, r, p, rz, rr = state
        Ap = A(p)
        alpha = psum_totals([_mul(p, Ap)], then=lambda pAp: rz / torch.clamp(pAp[0], min=1e-30))
        x_step = _axpy(x, alpha, p)
        r_new = _axpy(r, alpha, Ap, sign=-1.0)
        z_raw = M(r_new)
        # The two projections' totals in one reduction.
        means = psum_totals([x_step, z_raw], then=lambda t: t / n_total)
        x_new = _minus(x_step, means, 0, ones)
        z = _minus(z_raw, means, 1, ones)
        sums = psum_totals([_mul(r_new, z), _mul(r_new, r_new)])[0]
        rz_new, rr_new = sums[0], sums[1]
        beta = broadcast(rz_new / torch.clamp(rz, min=1e-30), z)
        return x_new, r_new, _axpy(z, beta, p), rz_new, rr_new

    (x, *_), _ = iterate_while(cond, body, (x, r, z, rz, rr), maxiter)
    return project(x)


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor], value: float) -> torch.Tensor:
    """``where(mask, value, x)``; no mask (an interior shard): ``x``."""
    return x if mask is None else torch.where(mask, value, x)


def _edge_masks(line: list) -> tuple:
    """Per shard, the mask of its first row where it is the global first
    row (shard 0) and of its last row where it is the global last row
    (the last shard); None elsewhere."""
    num = len(line)
    first, last = [None] * num, [None] * num
    for i in (0, num - 1):
        rows = torch.arange(line[i].shape[0], device=line[i].device).reshape(
            (-1,) + (1,) * (line[i].dim() - 1)
        )
        shape = tuple(line[i].shape)
        if i == 0:
            first[i] = (rows == 0).expand(shape)
        if i == num - 1:
            last[i] = (rows == shape[0] - 1).expand(shape)
    return first, last


def local_tpfa_operator(trans_rows_p: list, trans_col: list) -> tuple:
    """``(A, diag)`` of the TPFA blocks of a line of row shards.

    ``trans_rows_p[i][k]`` is the transmissibility of the face ABOVE local
    row ``k`` of shard ``i`` (shard 0's row 0 is the absent global boundary
    face, masked).
    """
    below = shift([t[:1] for t in trans_rows_p], -1)
    trans_row_ext = [torch.cat([t, b], dim=0) for t, b in zip(trans_rows_p, below)]
    first, last = _edge_masks(trans_rows_p)

    def A(p):
        p_ext = halo_exchange(p, 1, axis=0)
        return [
            _local_tpfa_apply(pe, te, tc, f, la)
            for pe, te, tc, f, la in zip(p_ext, trans_row_ext, trans_col, first, last)
        ]

    diag = []
    for te, tc, f, la in zip(trans_row_ext, trans_col, first, last):
        diag_col = torch.zeros_like(te[:-1])
        diag_col[:, :-1] += tc
        diag_col[:, 1:] += tc
        t_up = _masked(te[:-1], f, 0.0)
        t_down = _masked(te[1:], la, 0.0)
        diag.append(torch.clamp(diag_col + t_up + t_down, min=1e-30))
    return A, diag


def _local_tpfa_apply(p_ext, trans_row_ext, trans_col, first, last):
    """A p on one shard from its 1-row halo-extended pressure block.

    Args:
        p_ext: (local_rows + 2, W) halo-extended pressure.
        trans_row_ext: (local_rows + 1, W) row-face transmissibilities,
            including the face to the next shard.
        trans_col: (local_rows, W - 1) column-face transmissibilities.
        first, last: masks of the global boundary rows (or None).
    """
    inner = p_ext[1:-1]
    out = torch.zeros_like(inner)
    out = out + _masked(trans_row_ext[:-1] * (inner - p_ext[:-2]), first, 0.0)
    out = out + _masked(trans_row_ext[1:] * (inner - p_ext[2:]), last, 0.0)
    # Column fluxes are shard-local; the face flux t*(p_j - p_{j+1}) enters
    # cell j positively and cell j+1 negatively.
    flux = trans_col * (inner[:, :-1] - inner[:, 1:])
    out[:, :-1] += flux
    out[:, 1:] -= flux
    return out


def sharded_tpfa_cg(
    mesh: Mesh,
    shape: tuple,
    axis: str = "space",
    tol: float = 1e-6,
    maxiter: int = 500,
):
    """Build a sharded CG solve for the pure-Neumann TPFA system.

    Returns ``solve(trans_rows, trans_cols, rhs) -> p`` where
    ``trans_rows`` has shape (H-1, W), ``trans_cols`` (H, W-1), ``rhs``
    (H, W), all split by rows over ``axis``; ``p`` lies on the mesh's first
    device.  H must divide by the axis size; other mesh axes must have size 1.
    """
    H, W = shape
    num = len(mesh.line(axis))
    if H % num:
        raise ValueError("Rows must divide the space mesh axis.")
    rows = Placement(mesh, (axis, None))

    def solve(trans_rows, trans_cols, rhs) -> torch.Tensor:
        trans_rows = torch.as_tensor(trans_rows)
        # Pad the (H-1, W) row faces to (H, W): entry k = face above row k.
        trans_rows_p = torch.cat([torch.zeros_like(trans_rows[:1]), trans_rows], dim=0)
        A, diag = local_tpfa_operator(
            rows.split_line(trans_rows_p), rows.split_line(torch.as_tensor(trans_cols))
        )
        p = projected_pcg_local(A, diag, rows.split_line(torch.as_tensor(rhs)), tol, maxiter)
        return rows.join_line(p)

    return solve
