"""Matrix-free stencil solver for ``mass*x - div(D grad x) = rhs``.

Counterpart of :mod:`darsia_tpu.ops.solvers` (the damped Jacobi lane).  The
sweeps run as a Python loop of tensor ops (the JAX package's
``lax.fori_loop``).
"""

from __future__ import annotations

import torch

from ..utils.derivatives import fv_laplace

__all__ = ["jacobi_solve", "neighbor_accumulation", "operator_diagonal"]


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
    # Zero-flux FV operator, the fixed point of the JAX package's Jacobi.
    return mass_coeff * x - fv_laplace(x, dim=dim, h=h, diffusion_coeff=diffusion_coeff)


def operator_diagonal(mass_coeff, diffusion_coeff, shape, dim, h, device):
    """Exact diagonal of ``mass*I - div(D grad)`` via 2-colouring."""
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


def jacobi_solve(
    x0: torch.Tensor,
    rhs: torch.Tensor,
    mass_coeff,
    diffusion_coeff,
    dim: int = 2,
    h: float = 1.0,
    maxiter: int = 1,
    omega: float = 0.8,
) -> torch.Tensor:
    """Damped Jacobi sweeps in residual form, ``x <- x + omega D^-1 (rhs - A x)``."""
    diag = operator_diagonal(
        mass_coeff, diffusion_coeff, tuple(x0.shape), dim, h, x0.device
    )
    x = x0
    for _ in range(maxiter):
        residual = rhs - _operator(x, mass_coeff, diffusion_coeff, dim, h)
        x = x + omega * residual / diag
    return x
