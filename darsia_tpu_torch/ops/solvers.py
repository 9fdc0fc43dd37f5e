"""Matrix-free stencil solvers for ``mass*x - div(D grad x) = rhs``.

Counterpart of :mod:`darsia_tpu.ops.solvers`: damped Jacobi, conjugate
gradients and geometric multigrid with Jacobi smoothing, all built from
stencil ops on tensors of the caller's device.  The first ``dim`` axes are
spatial; the coefficients are scalars or tensors broadcastable to the image.

Fixed-count loops (the JAX package's ``lax.fori_loop``) are Python loops of
tensor ops and never read a tensor on the host.  Loops with a stopping rule
(``lax.while_loop``) go through :func:`iterate_while`, which computes the rule
on the device and reads it once per iteration.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..utils.derivatives import fv_laplace

__all__ = [
    "build_coefficient_pyramid",
    "cg_operator",
    "cg_solve",
    "clamp_depth",
    "gmres_operator",
    "iterate_while",
    "iterate_while_batched",
    "jacobi_solve",
    "mg_solve",
    "neighbor_accumulation",
    "operator_diagonal",
]

def iterate_while(
    cond: Callable[[tuple, int], Union[bool, torch.Tensor]],
    body: Callable[[tuple, int], tuple],
    state: tuple,
    maxiter: int,
    start: int = 0,
) -> tuple:
    """``while it < maxiter and cond(state, it): state = body(state, it)``.

    ``cond`` returns a bool or a 0-d bool tensor, which is read on the host
    once per iteration: the loop's only host read.  Measured on an H100 against a
    loop that computes every iteration, freezes the state with
    ``torch.where`` once the test fails and reads the flag every eighth
    iteration (``chip_smoke.py``, PERF.md): the read costs less than the
    extra pass over the state.

    Returns the final state and the number of iterations taken.
    """
    it = start
    while it < maxiter and bool(cond(state, it)):
        state = body(state, it)
        it += 1
    return state, it


def iterate_while_batched(
    cond: Callable[[tuple, int], torch.Tensor],
    body: Callable[[tuple, int], tuple],
    state: tuple,
    maxiter: int,
    active: Optional[torch.Tensor] = None,
) -> tuple:
    """:func:`iterate_while` over a batch of independent problems, as
    ``jax.vmap`` runs a ``lax.while_loop``: ``cond`` returns a ``(B,)`` bool
    tensor, the body runs for the whole batch, and each problem whose test
    has failed once keeps its state (``torch.where``) from then on.  Every
    tensor of ``state`` has the batch as its leading axis.  ``active`` (a ``(B,)`` bool tensor) holds some problems
    still from the start.

    The host reads the ``(B,)`` flags once per iteration, as
    :func:`iterate_while` reads its one flag: the launches per iteration do
    not grow with the batch.

    Returns the final state and the iterations each problem took, a
    ``(B,)`` numpy array.
    """
    counts = np.zeros(state[0].shape[0], np.int64)
    for it in range(maxiter):
        test = cond(state, it)
        active = test if active is None else active & test
        flags = active.cpu().numpy()
        if not flags.any():
            break
        counts += flags
        new = body(state, it)
        state = tuple(
            torch.where(active.reshape(active.shape + (1,) * (s.dim() - 1)), n, s)
            for n, s in zip(new, state)
        )
    return state, counts


def neighbor_accumulation(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the 2*dim neighbours with edge replication (ghost copies)."""
    out = torch.zeros_like(x)
    for ax in range(dim):
        n = x.shape[ax]
        first = x.narrow(ax, 0, 1)
        last = x.narrow(ax, n - 1, 1)
        shifted_up = torch.cat([first, x.narrow(ax, 0, n - 1)], dim=ax)
        shifted_down = torch.cat([x.narrow(ax, 1, n - 1), last], dim=ax)
        out = out + shifted_up + shifted_down
    return out


def _operator(x, mass_coeff, diffusion_coeff, dim, h):
    # Zero-flux FV operator, the fixed point of the JAX package's Jacobi and
    # the adjoint of the TVD shrinkage gradient.
    return mass_coeff * x - fv_laplace(x, dim=dim, h=h, diffusion_coeff=diffusion_coeff)


def operator_diagonal(mass_coeff, diffusion_coeff, shape, dim, h, device):
    """Exact diagonal of ``mass*I - div(D grad)`` via 2-colouring.

    Applying the operator to the two checkerboard indicator fields and
    masking recovers the diagonal of a nearest-neighbour stencil, boundary
    closures and heterogeneous coefficients included.
    """
    idx_sum = sum(
        torch.arange(shape[d], device=device).reshape(
            [-1 if k == d else 1 for k in range(len(shape))]
        )
        for d in range(dim)
    )
    checker = (idx_sum % 2).to(torch.float32).expand(shape)
    diag = torch.zeros(shape, dtype=torch.float32, device=device)
    for color in (checker, 1.0 - checker):
        diag = diag + color * _operator(color, mass_coeff, diffusion_coeff, dim, h)
    return diag


def _sweeps(x, rhs, mass_coeff, diffusion_coeff, dim, h, iters, omega, diag=None):
    if diag is None:
        diag = operator_diagonal(
            mass_coeff, diffusion_coeff, tuple(x.shape), dim, h, x.device
        )
    for _ in range(iters):
        residual = rhs - _operator(x, mass_coeff, diffusion_coeff, dim, h)
        x = x + omega * residual / diag
    return x


def jacobi_solve(
    x0: torch.Tensor,
    rhs: torch.Tensor,
    mass_coeff,
    diffusion_coeff,
    dim: int = 2,
    h: float = 1.0,
    maxiter: int = 1,
    omega: float = 0.8,
    diag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Damped Jacobi sweeps in residual form, ``x <- x + omega D^-1 (rhs - A x)``
    with the exact stencil diagonal (also the multigrid smoother).

    ``diag`` takes the diagonal (:func:`operator_diagonal` at these
    coefficients, shape and ``h``) from a caller that solves repeatedly with
    the same coefficients; it is computed here otherwise.
    """
    return _sweeps(x0, rhs, mass_coeff, diffusion_coeff, dim, h, maxiter, omega, diag)


def cg_solve(
    x0: torch.Tensor,
    rhs: torch.Tensor,
    mass_coeff,
    diffusion_coeff,
    dim: int = 2,
    h: float = 1.0,
    tol: float = 1e-8,
    maxiter: int = 100,
) -> torch.Tensor:
    """Conjugate gradients on the stencil operator; stops when the squared
    residual falls to ``tol**2`` times the squared norm of ``rhs``."""
    return cg_operator(lambda x: _operator(x, mass_coeff, diffusion_coeff, dim, h), rhs, x0, tol, maxiter)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.flatten(), b.flatten())


def cg_operator(
    A: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 100,
) -> torch.Tensor:
    """Conjugate gradients for a symmetric positive definite operator ``A``
    (a callable on tensors shaped as ``rhs``), the stopping rule of
    ``jax.scipy.sparse.linalg.cg``: the squared residual at most ``tol**2``
    times the squared norm of ``rhs``, read once per iteration."""
    r0 = rhs - A(x0)
    rs0 = _dot(r0, r0)
    threshold = tol**2 * _dot(rhs, rhs).clamp(min=1e-30)

    def cond(state, it):
        return state[3] > threshold

    def body(state, it):
        x, r, p, rs = state
        Ap = A(p)
        alpha = rs / _dot(p, Ap).clamp(min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        beta = rs_new / rs.clamp(min=1e-30)
        return (x, r, r + beta * p, rs_new)

    (x, *_), _ = iterate_while(cond, body, (x0, r0, r0, rs0), maxiter)
    return x


def gmres_operator(
    A: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-5,
    maxiter: Optional[int] = None,
) -> torch.Tensor:
    """Restarted GMRES for a general operator ``A`` (a callable on tensors
    shaped as ``rhs``), with the defaults of ``jax.scipy.sparse.linalg.gmres``:
    Krylov spaces of 20 vectors (at most the size of ``rhs``), at most
    ``maxiter`` of them (10 times the size when None), stopping once the
    residual norm is at most ``tol * |rhs|`` (``atol`` 0).

    The Arnoldi vectors and the matvecs stay on ``rhs``'s device (modified
    Gram-Schmidt); each Arnoldi step reads its column of the Hessenberg
    matrix on the host, where the Givens rotations give the residual norm
    without another pass.  The solution agrees with JAX's, not its
    iterations (JAX builds each Krylov space whole before it tests).
    """
    size = rhs.numel()
    restart = min(20, size)
    maxiter = 10 * size if maxiter is None else maxiter
    target = tol * float(torch.linalg.vector_norm(rhs))
    x = x0
    for _ in range(maxiter):
        r = rhs - A(x)
        beta = float(torch.linalg.vector_norm(r))
        if beta <= target or beta == 0.0:
            break
        basis = [r / beta]
        hessenberg = np.zeros((restart + 1, restart))
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        while k < restart:
            w = A(basis[k])
            column = []
            for v in basis:
                h = _dot(w, v)
                w = w - h * v
                column.append(h)
            column.append(torch.linalg.vector_norm(w))
            values = torch.stack(column).cpu().numpy().astype(np.float64)
            hessenberg[: k + 2, k] = values
            for i in range(k):
                a, b = hessenberg[i, k], hessenberg[i + 1, k]
                hessenberg[i, k], hessenberg[i + 1, k] = cs[i] * a + sn[i] * b, -sn[i] * a + cs[i] * b
            a, b = hessenberg[k, k], hessenberg[k + 1, k]
            rho = math.hypot(a, b)
            cs[k], sn[k] = (1.0, 0.0) if rho == 0.0 else (a / rho, b / rho)
            hessenberg[k, k], hessenberg[k + 1, k] = rho, 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k += 1
            if abs(g[k]) <= target or values[-1] == 0.0:
                break
            basis.append(w / column[-1])
        y = np.zeros(k)
        for i in range(k - 1, -1, -1):
            y[i] = (g[i] - hessenberg[i, i + 1 : k] @ y[i + 1 :]) / hessenberg[i, i]
        update = sum(float(c) * v for c, v in zip(y, basis[:k]))
        x = x + update
    return x


def _restrict(x, dim: int):
    """Coarsen by 2 per axis: average even/odd pairs, drop a trailing odd entry
    (a tensor, or a numpy coefficient field that is still on the host)."""
    for ax in range(dim):
        n = x.shape[ax]
        index = [slice(None)] * x.ndim
        index[ax] = slice(0, n - n % 2, 2)
        even = x[tuple(index)]
        index[ax] = slice(1, n, 2)
        odd = x[tuple(index)]
        x = (even + odd) / 2
    return x


def _prolong(x: torch.Tensor, target_shape: tuple, dim: int) -> torch.Tensor:
    """Refine by 2 per axis (nearest repeat) and edge-pad to the target shape."""
    for ax in range(dim):
        # Each entry twice, as a broadcast and a reshape (no host sync).
        doubled = list(x.shape)
        doubled[ax] *= 2
        x = x.unsqueeze(ax + 1).expand(*x.shape[: ax + 1], 2, *x.shape[ax + 1 :]).reshape(doubled)
    for ax in range(dim):
        missing = target_shape[ax] - x.shape[ax]
        if missing > 0:
            last = x.narrow(ax, x.shape[ax] - 1, 1)
            x = torch.cat([x] + [last] * missing, dim=ax)
    return x


def build_coefficient_pyramid(coeff, shape: tuple, dim: int, depth: int) -> list:
    """Per-level restriction of a coefficient (a scalar stays as it is)."""
    levels = [coeff]
    for _ in range(depth):
        if isinstance(coeff, torch.Tensor) and coeff.dim() >= dim:
            coeff = _restrict(coeff, dim)
        levels.append(coeff)
    return levels


def clamp_depth(depth: int, shape: tuple, dim: int) -> int:
    """The multigrid depth that keeps the coarsest level non-degenerate."""
    return min(depth, max(int(math.log2(max(min(shape[:dim]), 2))) - 1, 0))


def mg_solve(
    x0: torch.Tensor,
    rhs: torch.Tensor,
    mass_pyramid: tuple,
    diffusion_pyramid: tuple,
    dim: int = 2,
    h: float = 1.0,
    depth: int = 2,
    smoother_iterations: int = 5,
    maxiter: int = 100,
    tol: Optional[float] = None,
    diagonals: Optional[dict] = None,
) -> torch.Tensor:
    """Geometric multigrid V-cycles with damped Jacobi (0.8) smoothing.

    The coefficients come as per-level pyramids
    (:func:`build_coefficient_pyramid`, ``depth + 2`` levels).  With
    ``tol=None`` exactly ``maxiter`` cycles run; else the cycles stop when the
    increment ``|x - x_prev| / |x0|`` falls below ``tol``.

    Each level's operator diagonal is computed once and kept in
    ``diagonals`` (level -> tensor); a caller that solves repeatedly with the
    same pyramids, shape and ``h`` passes the same dict again.
    """
    diagonals = {} if diagonals is None else diagonals

    def smoother(x, b, level, hh):
        mass, diff = mass_pyramid[level], diffusion_pyramid[level]
        if level not in diagonals:
            diagonals[level] = operator_diagonal(
                mass, diff, tuple(x.shape), dim, hh, x.device
            )
        return _sweeps(
            x, b, mass, diff, dim, hh, smoother_iterations, 0.8, diagonals[level]
        )

    def v_cycle(x, b, level, remaining_depth, hh):
        x = smoother(x, b, level, hh)
        r = b - _operator(x, mass_pyramid[level], diffusion_pyramid[level], dim, hh)
        rc = _restrict(r, dim)
        if remaining_depth == 0:
            eps = smoother(torch.zeros_like(rc), rc, level + 1, 2 * hh)
        else:
            eps = v_cycle(torch.zeros_like(rc), rc, level + 1, remaining_depth - 1, 2 * hh)
        x = x + _prolong(eps, tuple(x.shape), dim)
        return smoother(x, b, level, hh)

    if tol is None:
        x = x0
        for _ in range(maxiter):
            x = v_cycle(x, rhs, 0, depth, h)
        return x

    x0_norm = torch.linalg.vector_norm(x0).clamp(min=1e-30)

    def cond(state, it):
        x, prev = state
        if it == 0:
            return True
        return torch.linalg.vector_norm(x - prev) / x0_norm >= tol

    def body(state, it):
        x, _ = state
        return (v_cycle(x, rhs, 0, depth, h), x)

    (x, _), _ = iterate_while(cond, body, (x0, x0 + 1.0), maxiter)
    return x
