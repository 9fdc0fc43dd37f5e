"""Split-Bregman total-variation denoising with heterogeneous weights.

Counterpart of :mod:`darsia_tpu.restoration.split_bregman_tvd`.  The Bregman
iteration (inner diffusion solve with Jacobi, CG or MG, shrinkage, optional
convergence test) is a Python loop of tensor ops on the image's device.
With ``eps=None`` and a Jacobi or MG solver it never reads a tensor on the
host; with ``eps`` the stopping rule is computed on the device and read once
per iteration (:func:`darsia_tpu_torch.ops.solvers.iterate_while`).

The splitting variables ``d`` and ``b`` are ``(*shape, dim)`` at the
interface (``x0=``), as in the JAX package, and lists of ``dim`` component
tensors inside.  The operator diagonal and the multigrid pyramids depend only
on the weights and are built once per call (again when ``adaptive`` changes
``ell``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..image.image import as_tensor
from ..ops.solvers import (
    build_coefficient_pyramid,
    cg_solve,
    clamp_depth,
    iterate_while,
    jacobi_solve,
    mg_solve,
    operator_diagonal,
)
from ..utils.derivatives import backward_diff, forward_diff
from ..utils.dtype import convert_dtype
from ..utils.linear_solvers import CG, MG, Jacobi, Solver

__all__ = ["split_bregman_tvd"]


def _make_linear_solve(solver: Solver, dim: int, shape: tuple, mass, diff) -> Callable:
    """``solve(x0, rhs)`` for the configured solver at fixed coefficients."""
    device = mass.device
    if isinstance(solver, MG):
        depth = clamp_depth(solver.depth, shape, dim)
        mass_pyr = tuple(build_coefficient_pyramid(mass, shape, dim, depth + 1))
        diff_pyr = tuple(build_coefficient_pyramid(diff, shape, dim, depth + 1))
        diagonals: dict = {}

        def solve(x0, rhs):
            return mg_solve(
                x0,
                rhs,
                mass_pyr,
                diff_pyr,
                dim=dim,
                depth=depth,
                smoother_iterations=solver.smoother_iterations,
                maxiter=solver.maxiter,
                diagonals=diagonals,
            )

        return solve
    if isinstance(solver, CG):
        tol = solver.tol if solver.tol is not None else 1e-8

        def solve(x0, rhs):
            return cg_solve(x0, rhs, mass, diff, dim=dim, tol=tol, maxiter=solver.maxiter)

        return solve
    # Jacobi, also for any plain Solver.
    maxiter = max(solver.maxiter, 1)
    diag = operator_diagonal(mass, diff, shape, dim, 1.0, device)

    def solve(x0, rhs):
        return jacobi_solve(x0, rhs, mass, diff, dim=dim, maxiter=maxiter, diag=diag)

    return solve


def _total(terms) -> torch.Tensor:
    terms = list(terms)
    total = terms[0]
    for term in terms[1:]:
        total = total + term
    return total


def _bregman(
    work: torch.Tensor,
    mu: torch.Tensor,
    omega: torch.Tensor,
    ell: torch.Tensor,
    dim: int,
    max_num_iter: int,
    eps: Optional[float],
    x_init: torch.Tensor,
    d_init: list,
    b_init: list,
    isotropic: bool,
    solver: Solver,
    adaptive_flags: tuple,
) -> tuple:
    """The denoised float32 tensor and the iterations taken."""
    shape = tuple(work.shape)
    img_nrm = torch.linalg.vector_norm(work).clamp(min=1e-30) if eps is not None else None
    weighted = omega * work
    # The inner solve at the current ell; rebuilt when ``adaptive`` fires.
    inner = {"solve": _make_linear_solve(solver, dim, shape, omega, ell)}

    def shrink_step(x_new, b, ell_cur):
        dub = [backward_diff(x_new, j, dim) + b[j] for j in range(dim)]
        k = mu / ell_cur
        if isotropic:
            s = torch.sqrt(_total(c * c for c in dub))
            shrinkage = (s - k).clamp(min=0.0) / (s + 1e-18)
            d = [c * shrinkage for c in dub]
        else:
            d = [(c.abs() - k).clamp(min=0.0) * torch.sign(c) for c in dub]
        return d, [c - dj for c, dj in zip(dub, d)]

    def iteration(state, it):
        x, d, b, ell_cur = state[0], state[1 : 1 + dim], state[1 + dim : 1 + 2 * dim], state[-1]
        rhs = weighted
        for i in range(dim):
            rhs = rhs + forward_diff(ell_cur * (b[i] - d[i]), axis=i, dim=dim)
        x_new = inner["solve"](x, rhs)
        d, b = shrink_step(x_new, b, ell_cur)
        if eps is None:
            inc = state[-2]
        else:
            inc = torch.linalg.vector_norm(x_new - x) / img_nrm
        if adaptive_flags[it]:
            total = _total(backward_diff(x_new, j, dim).abs() for j in range(dim))
            ell_cur = 1.0 / total.clamp(min=1e-12)
            inner["solve"] = _make_linear_solve(solver, dim, shape, omega, ell_cur)
        return (x_new, *d, *b, inc, ell_cur)

    state = (x_init, *d_init, *b_init, torch.ones((), device=work.device), ell)
    if eps is None:
        for it in range(max_num_iter):
            state = iteration(state, it)
        return state[0], max_num_iter

    def cond(state, it):
        if it == 0:
            return True
        return state[-2] >= eps

    state, taken = iterate_while(cond, iteration, state, max_num_iter)
    return state[0], taken


def _weight(value, device) -> torch.Tensor:
    """A scalar or field weight as a float32 tensor on ``device``."""
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return as_tensor(value, device).to(torch.float32)
    return torch.tensor(value, dtype=torch.float32, device=device)


def split_bregman_tvd(
    img,
    mu: Union[float, np.ndarray, torch.Tensor] = 1.0,
    omega: Union[float, np.ndarray, torch.Tensor] = 1.0,
    ell: Optional[Union[float, np.ndarray, torch.Tensor]] = None,
    dim: int = 2,
    max_num_iter: int = 100,
    eps: Optional[float] = None,
    x0: Optional[tuple] = None,
    isotropic: bool = False,
    verbose: Union[bool, int] = False,
    solver: Optional[Solver] = None,
    adaptive=None,
    device=None,
) -> torch.Tensor:
    """Split-Bregman TV denoising.

    Args:
        img: image tensor (it stays on its device) or numpy array (it goes to
            ``device``, the CUDA card by default); any image dtype, returned
            in the same dtype.
        mu: TV penalization (scalar or heterogeneous field).
        omega: mass penalization (scalar or field).
        ell: Bregman regularization weight; defaults to ``2 * mu``.
        dim: number of spatial axes.
        max_num_iter: outer Bregman iterations.
        eps: early-exit tolerance on the relative increment.
        x0: optional (image, d, b) initial state, d and b of shape
            ``(*img.shape, dim)``.
        isotropic: isotropic vs anisotropic shrinkage.
        verbose: unused (kept for the signature).
        solver: inner diffusion solver (Jacobi/CG/MG); Jacobi(20) default.
        adaptive: optional ``iter -> bool`` schedule triggering reweighting
            of ell from the current gradient.
        device: where numpy inputs go.

    """
    img = as_tensor(img, device)
    device = img.device
    work = convert_dtype(img, torch.float32)

    if ell is None:
        ell = 2 * mu
    if solver is None:
        solver = Jacobi(maxiter=20)
    solver.update_params(mass_coeff=omega, diffusion_coeff=ell, dim=dim)

    if x0 is not None:
        img0, d0, b0 = x0
        x_init = convert_dtype(as_tensor(img0, device), torch.float32)
        d0 = as_tensor(d0, device).to(torch.float32)
        b0 = as_tensor(b0, device).to(torch.float32)
        d_init = [d0[..., i] for i in range(dim)]
        b_init = [b0[..., i] for i in range(dim)]
    else:
        x_init = work
        d_init = [torch.zeros_like(work) for _ in range(dim)]
        b_init = [torch.zeros_like(work) for _ in range(dim)]

    adaptive_flags = tuple(
        bool(adaptive(i)) if adaptive is not None else False for i in range(max_num_iter)
    )
    result, _ = _bregman(
        work,
        _weight(mu, device),
        _weight(omega, device),
        _weight(ell, device),
        dim,
        int(max_num_iter),
        None if eps is None else float(eps),
        x_init,
        d_init,
        b_init,
        bool(isotropic),
        solver,
        adaptive_flags,
    )
    return convert_dtype(result, img.dtype)
