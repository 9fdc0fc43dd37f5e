"""H1 regularization (mass + diffusion smoothing).

Counterpart of :mod:`darsia_tpu.restoration.h1_regularization`: solves
``min_u 1/2||u - img||_{2,omega}^2 + 1/2||grad u||_{2,mu}^2`` with a stencil
solver.  Trailing channel axes are solved in one batched call where that is
bitwise what channel-by-channel solves give (Jacobi, and MG with a fixed
count: elementwise stencils only); CG and MG with a tolerance reduce over the
whole tensor, so they solve channel by channel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..image.image import as_tensor
from ..utils.dtype import convert_dtype
from ..utils.linear_solvers import MG, Jacobi, Solver

__all__ = ["H1_regularization"]


def _regularize_array(img: torch.Tensor, mu, omega, dim, solver) -> torch.Tensor:
    work = convert_dtype(img, torch.float32)

    def prepare(weight, batch_axes):
        # A field weight on the image's device, broadcast over batch axes.
        if isinstance(weight, (np.ndarray, torch.Tensor)):
            weight = as_tensor(weight, work.device).to(torch.float32)
            if weight.dim() == dim:
                weight = weight.reshape(weight.shape + (1,) * batch_axes)
        return weight

    elementwise = type(solver) is Jacobi or (type(solver) is MG and solver.tol is None)
    if work.dim() == dim or elementwise:
        batch_axes = work.dim() - dim
        mu_b, omega_b = prepare(mu, batch_axes), prepare(omega, batch_axes)
        solver.update_params(mass_coeff=omega_b, diffusion_coeff=mu_b, dim=dim)
        out = solver(x0=work, rhs=omega_b * work)
    else:
        mu_b, omega_b = prepare(mu, 0), prepare(omega, 0)
        solver.update_params(mass_coeff=omega_b, diffusion_coeff=mu_b, dim=dim)
        flat = work.reshape(*work.shape[:dim], -1)
        solved = [
            solver(x0=flat[..., k], rhs=omega_b * flat[..., k])
            for k in range(flat.shape[-1])
        ]
        out = torch.stack(solved, dim=-1).reshape(work.shape)
    return convert_dtype(out, img.dtype)


def H1_regularization(
    img,
    mu,
    omega=1.0,
    dim: int = 2,
    solver: Optional[Solver] = None,
    device=None,
):
    """H1-regularize a tensor, numpy array (it goes to ``device``, the CUDA
    card by default) or Image (same return type); ``mu`` and ``omega`` are
    scalars or fields over the spatial axes."""
    solver = solver or Jacobi(maxiter=30)
    if hasattr(img, "img"):
        out = img.copy()
        out.img = _regularize_array(img.img, mu, omega, dim, solver)
        return out
    return _regularize_array(as_tensor(img, device), mu, omega, dim, solver)
