"""Solver classes (the Jacobi lane).

Counterpart of :mod:`darsia_tpu.utils.linear_solvers`: the stateful,
config-friendly interface over :mod:`darsia_tpu_torch.ops.solvers`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops.solvers import jacobi_solve

__all__ = ["Jacobi", "Solver"]


class Solver:
    """Base class carrying the problem coefficients."""

    def __init__(
        self,
        maxiter: int = 1,
        tol: Optional[float] = None,
        dim: int = 2,
        mass_coeff=None,
        diffusion_coeff=None,
        verbose: bool = False,
    ) -> None:
        self.dim = dim
        self.maxiter = maxiter
        self.tol = tol
        self.mass_coeff = mass_coeff
        self.diffusion_coeff = diffusion_coeff
        self.verbose = verbose

    def update_params(
        self, dim: Optional[int] = None, mass_coeff=None, diffusion_coeff=None
    ) -> None:
        if dim is not None:
            self.dim = dim
        if mass_coeff is not None:
            self.mass_coeff = mass_coeff
        if diffusion_coeff is not None:
            self.diffusion_coeff = diffusion_coeff

    def _coeffs(self):
        mass = self.mass_coeff if self.mass_coeff is not None else 1.0
        diff = self.diffusion_coeff if self.diffusion_coeff is not None else 1.0
        return mass, diff

    def __call__(self, x0, rhs, h: float = 1.0):
        raise NotImplementedError


class Jacobi(Solver):
    """Fixed count of damped Jacobi sweeps (no tolerance-based exit)."""

    def __call__(self, x0: torch.Tensor, rhs: torch.Tensor, h: float = 1.0):
        mass, diff = self._coeffs()
        return jacobi_solve(
            x0.to(torch.float32),
            rhs.to(torch.float32),
            mass,
            diff,
            dim=self.dim,
            h=h,
            maxiter=self.maxiter,
        )
