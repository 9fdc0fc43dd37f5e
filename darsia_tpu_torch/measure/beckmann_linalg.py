"""Pluggable linear solvers for the Beckmann pressure systems.

Counterpart of :mod:`darsia_tpu.measure.beckmann_linalg` (reference
``measure/beckmann_linalg.py``: Direct, AMG, CG, KSP, KSP-FieldSplit and the
factory).  Every solver runs on the matrix-free TPFA stencil of
:mod:`beckmann_kernels`, on the device of the transmissibilities: a dense
float64 host solve for tiny systems, nullspace-projected Jacobi-CG, and CG
preconditioned by a Galerkin geometric-MG V-cycle in the roles of pyamg and
PETSc/Hypre.  PETSc-style option dictionaries map onto the tolerances.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np
import torch

from ..image.image import as_tensor
from .beckmann_kernels import tpfa_apply, tpfa_cg, tpfa_mg_levels, tpfa_mg_pcg

__all__ = [
    "BeckmannLinearSolverType",
    "BeckmannLinearSolver",
    "BeckmannDirectSolver",
    "BeckmannAMGSolver",
    "BeckmannCGSolver",
    "BeckmannKSPSolver",
    "BeckmannKSPFieldSplitSolver",
    "BeckmannLinearSolverFactory",
]


class BeckmannLinearSolverType(str, Enum):
    DIRECT = "direct"
    AMG = "amg"
    CG = "cg"
    KSP = "ksp"
    KSP_FIELDSPLIT = "ksp-fieldsplit"


class BeckmannLinearSolver:
    """Solve the pure-Neumann TPFA system div(w grad p) = rhs.

    ``setup(trans)`` receives the per-dimension face transmissibilities
    (tensors stay where they are; numpy goes to the CUDA card);
    ``solve(rhs, x0)`` works on grid-shaped arrays on their device.
    """

    def __init__(self, shape: tuple, options: Optional[dict] = None) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.dim = len(self.shape)
        self.options = options or {}
        self.tol = float(self.options.get("rtol", self.options.get("tol", 1e-6)))
        self.max_iter = int(
            self.options.get("maxiter", self.options.get("num_iter", 500))
        )
        self.trans: Optional[tuple] = None

    def setup(self, trans: tuple) -> None:
        self.trans = tuple(as_tensor(t) for t in trans)

    def _operands(self, rhs, x0):
        device = self.trans[0].device
        rhs = as_tensor(rhs, device).reshape(self.shape)
        x0 = (
            torch.zeros(self.shape, dtype=rhs.dtype, device=device)
            if x0 is None
            else as_tensor(x0, device).reshape(self.shape)
        )
        return rhs, x0

    def solve(self, rhs, x0=None):
        raise NotImplementedError


class BeckmannCGSolver(BeckmannLinearSolver):
    """Nullspace-projected Jacobi-preconditioned CG (matrix-free)."""

    def solve(self, rhs, x0=None):
        assert self.trans is not None, "Call setup(trans) first."
        rhs, x0 = self._operands(rhs, x0)
        return tpfa_cg(
            self.trans, rhs, x0, dim=self.dim, tol=self.tol, maxiter=self.max_iter
        )


class BeckmannDirectSolver(BeckmannLinearSolver):
    """Dense factorization with pinned nullspace (small grids only;
    reference: scipy splu).  The operator is assembled by applying the
    stencil to the unit vectors (one batched call) and solved in float64
    numpy on the host."""

    _MAX_CELLS = 4096

    def setup(self, trans: tuple) -> None:
        super().setup(trans)
        n = int(np.prod(self.shape))
        if n > self._MAX_CELLS:
            raise ValueError(
                f"Direct solver assembles a dense {n}x{n} operator; use CG "
                "for large grids."
            )
        t0 = self.trans[0]
        eye = torch.eye(n, dtype=t0.dtype, device=t0.device).reshape((n,) + self.shape)
        columns = tpfa_apply(eye, self.trans, self.dim).reshape(n, n)
        A = columns.T.cpu().numpy().astype(np.float64)
        A += np.ones((n, n)) / n  # pin the constant mode
        self._A = A

    def solve(self, rhs, x0=None):
        device = self.trans[0].device
        rhs_t = as_tensor(rhs, device)
        rhs = rhs_t.detach().cpu().numpy().astype(np.float64).ravel()
        rhs = rhs - rhs.mean()
        x = np.linalg.solve(self._A, rhs)
        x = (x - x.mean()).reshape(self.shape)
        return torch.from_numpy(x).to(device=device, dtype=self.trans[0].dtype)


class BeckmannAMGSolver(BeckmannLinearSolver):
    """Multilevel solver: CG preconditioned by a geometric-MG V-cycle (on the
    structured TPFA grid the Galerkin aggregation hierarchy is available in
    closed form, :func:`beckmann_kernels.tpfa_coarsen_trans`)."""

    def __init__(self, shape, options: Optional[dict] = None) -> None:
        options = dict(options or {})
        options.setdefault("maxiter", 200)
        super().__init__(shape, options)
        self.levels = int(options.get("levels", tpfa_mg_levels(self.shape)))

    def solve(self, rhs, x0=None):
        assert self.trans is not None, "Call setup(trans) first."
        rhs, x0 = self._operands(rhs, x0)
        return tpfa_mg_pcg(
            self.trans,
            rhs,
            x0,
            dim=self.dim,
            tol=self.tol,
            maxiter=self.max_iter,
            levels=self.levels,
        )


class BeckmannKSPSolver(BeckmannAMGSolver):
    """PETSc-KSP facade: accepts petsc-style options, runs MG-preconditioned
    projected CG (the reference KSP default is Hypre-AMG-preconditioned CG)."""

    def __init__(self, shape, options: Optional[dict] = None) -> None:
        options = dict(options or {})
        petsc = options.pop("petsc_options", {})
        options.setdefault("rtol", petsc.get("ksp_rtol", 1e-6))
        options.setdefault("maxiter", petsc.get("ksp_max_it", 500))
        super().__init__(shape, options)


class BeckmannKSPFieldSplitSolver(BeckmannKSPSolver):
    """Fieldsplit facade: the flux block is diagonal in the TPFA setting,
    so the Schur complement IS the projected pressure system solved here."""


class BeckmannLinearSolverFactory:
    """Instantiate solvers by type string."""

    _REGISTRY = {
        BeckmannLinearSolverType.DIRECT: BeckmannDirectSolver,
        BeckmannLinearSolverType.AMG: BeckmannAMGSolver,
        BeckmannLinearSolverType.CG: BeckmannCGSolver,
        BeckmannLinearSolverType.KSP: BeckmannKSPSolver,
        BeckmannLinearSolverType.KSP_FIELDSPLIT: BeckmannKSPFieldSplitSolver,
    }

    @classmethod
    def create(
        cls, solver_type, shape, options: Optional[dict] = None
    ) -> BeckmannLinearSolver:
        solver_type = BeckmannLinearSolverType(str(solver_type).lower())
        return cls._REGISTRY[solver_type](shape, options)
