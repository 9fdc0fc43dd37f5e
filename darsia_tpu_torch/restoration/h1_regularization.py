"""H1 regularization (mass + diffusion smoothing).

Counterpart of :mod:`darsia_tpu.restoration.h1_regularization`: solves
``min_u 1/2||u - img||_{2,omega}^2 + 1/2||grad u||_{2,mu}^2`` with a stencil
solver; trailing channel axes are batched by a loop over channels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.dtype import convert_dtype
from ..utils.linear_solvers import Jacobi, Solver

__all__ = ["H1_regularization"]


def _regularize_array(img: torch.Tensor, mu, omega, dim, solver) -> torch.Tensor:
    work = convert_dtype(img, torch.float32)
    solver.update_params(mass_coeff=omega, diffusion_coeff=mu, dim=dim)
    if work.dim() != dim:
        spatial = work.shape[:dim]
        flat = work.reshape(*spatial, -1)
        solved = [
            solver(x0=flat[..., k], rhs=omega * flat[..., k])
            for k in range(flat.shape[-1])
        ]
        out = torch.stack(solved, dim=-1).reshape(work.shape)
    else:
        out = solver(x0=work, rhs=omega * work)
    return convert_dtype(out, img.dtype)


def H1_regularization(
    img,
    mu: float,
    omega: float = 1.0,
    dim: int = 2,
    solver: Optional[Solver] = None,
):
    """H1-regularize a tensor or Image (same return type)."""
    solver = solver or Jacobi(maxiter=30)
    if hasattr(img, "img"):
        out = img.copy()
        out.img = _regularize_array(img.img, mu, omega, dim, solver)
        return out
    return _regularize_array(img, mu, omega, dim, solver)
