"""Matrix-free solver classes for ``mass_coeff * x - div(diffusion_coeff grad x) = rhs``.

Counterpart of :mod:`darsia_tpu.utils.linear_solvers`: the stateful,
config-friendly interface (``Jacobi``, ``CG``, ``MG``) over
:mod:`darsia_tpu_torch.ops.solvers`, used by the restoration layer.  ``x0``
and ``rhs`` are tensors and decide the device; coefficient fields given as
numpy arrays go there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.solvers import (
    _operator,
    _prolong,
    _restrict,
    build_coefficient_pyramid,
    cg_solve,
    clamp_depth,
    jacobi_solve,
    mg_solve,
)

__all__ = ["CG", "Jacobi", "MG", "Solver"]


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

    def _coeffs(self, device):
        """The coefficients (1.0 where unset), fields as float32 tensors on
        ``device``."""

        def prepare(coeff):
            if coeff is None:
                return 1.0
            if isinstance(coeff, np.ndarray):
                coeff = torch.from_numpy(np.ascontiguousarray(coeff))
            if isinstance(coeff, torch.Tensor):
                return coeff.to(device=device, dtype=torch.float32)
            return coeff

        return prepare(self.mass_coeff), prepare(self.diffusion_coeff)

    def __call__(self, x0, rhs, h: float = 1.0):
        raise NotImplementedError


class Jacobi(Solver):
    """Fixed count of damped Jacobi sweeps (no tolerance-based exit)."""

    def __call__(self, x0: torch.Tensor, rhs: torch.Tensor, h: float = 1.0):
        mass, diff = self._coeffs(x0.device)
        return jacobi_solve(
            x0.to(torch.float32),
            rhs.to(torch.float32),
            mass,
            diff,
            dim=self.dim,
            h=h,
            maxiter=self.maxiter,
        )


class CG(Solver):
    """Conjugate gradients on the stencil operator (``tol`` defaults to 1e-8)."""

    def __call__(self, x0: torch.Tensor, rhs: torch.Tensor, h: Optional[float] = None):
        mass, diff = self._coeffs(x0.device)
        return cg_solve(
            x0.to(torch.float32),
            rhs.to(torch.float32),
            mass,
            diff,
            dim=self.dim,
            h=1.0 if h is None else h,
            tol=self.tol if self.tol is not None else 1e-8,
            maxiter=self.maxiter,
        )


class MG(Solver):
    """Geometric multigrid V-cycle solver with Jacobi smoothing."""

    def __init__(
        self,
        depth: int = 2,
        smoother_iterations: int = 5,
        maxiter: int = 100,
        tol: Optional[float] = None,
        dim: int = 2,
        mass_coeff=None,
        diffusion_coeff=None,
        verbose: bool = False,
    ) -> None:
        super().__init__(maxiter, tol, dim, mass_coeff, diffusion_coeff, verbose)
        self.depth = depth
        self.smoother_iterations = smoother_iterations

    def _solve(self, x0, rhs, h, maxiter, tol):
        mass, diff = self._coeffs(x0.device)
        x0 = x0.to(torch.float32)
        # The depth is clamped so the coarsest level stays non-degenerate.
        depth = clamp_depth(self.depth, tuple(x0.shape), self.dim)
        shape = tuple(x0.shape)
        return mg_solve(
            x0,
            rhs.to(torch.float32),
            tuple(build_coefficient_pyramid(mass, shape, self.dim, depth + 1)),
            tuple(build_coefficient_pyramid(diff, shape, self.dim, depth + 1)),
            dim=self.dim,
            h=h,
            depth=depth,
            smoother_iterations=self.smoother_iterations,
            maxiter=maxiter,
            tol=tol,
        )

    def __call__(self, x0: torch.Tensor, rhs: torch.Tensor, h: float = 1.0):
        return self._solve(x0, rhs, h, self.maxiter, self.tol)

    # -- level-wise building blocks --

    def operator(self, x: torch.Tensor, h: float = 1.0) -> torch.Tensor:
        """Apply ``mass*x - div(diffusion grad x)`` at mesh size ``h``."""
        mass, diff = self._coeffs(x.device)
        return _operator(x.to(torch.float32), mass, diff, self.dim, h)

    def restriction(self, x: torch.Tensor) -> torch.Tensor:
        """Pairwise-mean restriction to the next-coarser grid."""
        return _restrict(x.to(torch.float32), self.dim)

    def prolongation(self, x: torch.Tensor, target_shape=None) -> torch.Tensor:
        """Interpolate to the next-finer grid (twice the size by default)."""
        x = x.to(torch.float32)
        if target_shape is None:
            target_shape = tuple(2 * s for s in x.shape[: self.dim]) + tuple(
                x.shape[self.dim :]
            )
        return _prolong(x, tuple(target_shape), self.dim)

    def restrict_parameters(self) -> None:
        """Coarsen coefficient fields one level, pushing the fine versions on
        a stack."""
        if not hasattr(self, "_parameter_stack"):
            self._parameter_stack = []
        self._parameter_stack.append((self.mass_coeff, self.diffusion_coeff))

        def coarsen(coeff):
            # A field is coarsened where it lies: a tensor on its device, a
            # numpy array on the host (a solve takes it to the data's device).
            if isinstance(coeff, np.ndarray) and coeff.ndim >= self.dim:
                return _restrict(coeff.astype(np.float32), self.dim)
            if isinstance(coeff, torch.Tensor) and coeff.dim() >= self.dim:
                return _restrict(coeff.to(torch.float32), self.dim)
            return coeff

        self.mass_coeff = coarsen(self.mass_coeff)
        self.diffusion_coeff = coarsen(self.diffusion_coeff)

    def prolongate_parameters(self, pad_tuple=None) -> None:
        """Undo the last :meth:`restrict_parameters`."""
        stack = getattr(self, "_parameter_stack", [])
        if not stack:
            raise RuntimeError("No restricted parameters to prolongate.")
        self.mass_coeff, self.diffusion_coeff = stack.pop()

    def base_V_Cycle(self, x0: torch.Tensor, rhs: torch.Tensor, h: float = 1.0):
        """One V-cycle: the solver with a single outer iteration."""
        return self._solve(x0, rhs, h, 1, None)
