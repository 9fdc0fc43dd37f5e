"""Krylov solver wrappers (PETSc-free).

Counterpart of :mod:`darsia_tpu.utils.linalg`: scipy's CG and GMRES for
assembled matrices (dense or sparse, on the host, as in the JAX package)
and the ``KSP`` facade over them.  A callable operator runs on tensors:
``cg`` through ``ops/solvers.py::cg_operator`` and ``gmres`` through
``ops/solvers.py::gmres_operator`` (restarted GMRES with the defaults of
``jax.scipy.sparse.linalg.gmres``), on the device of ``b`` (a numpy ``b``
goes to ``device``, the CUDA card when None).  The solution comes back as a
numpy array, as the JAX package returns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg  # noqa: F401  (sps.linalg)
import torch

from ..image.image import as_tensor
from ..ops.solvers import cg_operator, gmres_operator

__all__ = ["cg", "gmres", "CG", "GMRES", "KSP"]


def _is_sparse(A) -> bool:
    return sps.issparse(A)


def _operator_problem(b, x0, device) -> tuple:
    rhs = as_tensor(b, device)
    rhs = rhs if rhs.is_floating_point() else rhs.to(torch.float32)
    start = torch.zeros_like(rhs) if x0 is None else as_tensor(x0, rhs.device).to(rhs.dtype)
    return rhs, start


def cg(A, b, x0=None, tol: float = 1e-8, maxiter: Optional[int] = None, device=None):
    """Conjugate gradients for SPD systems (matrix, sparse, or callable)."""
    if _is_sparse(A) or isinstance(A, np.ndarray):
        x, info = sps.linalg.cg(A, np.asarray(b), x0=x0, rtol=tol, maxiter=maxiter)
        return x, info
    rhs, start = _operator_problem(b, x0, device)
    x = cg_operator(A, rhs, start, tol=tol, maxiter=10 * rhs.numel() if maxiter is None else maxiter)
    return x.cpu().numpy(), 0


def gmres(A, b, x0=None, tol: float = 1e-8, maxiter: Optional[int] = None, device=None):
    """GMRES for general systems (matrix, sparse, or callable)."""
    if _is_sparse(A) or isinstance(A, np.ndarray):
        x, info = sps.linalg.gmres(A, np.asarray(b), x0=x0, rtol=tol, maxiter=maxiter)
        return x, info
    rhs, start = _operator_problem(b, x0, device)
    x = gmres_operator(A, rhs, start, tol=tol, maxiter=maxiter)
    return x.cpu().numpy(), 0


class CG:
    """Stateful conjugate-gradient wrapper (matrix, sparse, or operator)."""

    def __init__(self, A) -> None:
        self.A = A
        self.scipy_options: dict = {}

    def setup(self, scipy_options: dict) -> None:
        """Store solver options (rtol/atol/maxiter as scipy understands)."""
        self.scipy_options = dict(scipy_options)

    def solve(self, b, **kwargs) -> np.ndarray:
        options = {**self.scipy_options, **kwargs}
        tol = options.pop("rtol", options.pop("tol", 1e-8))
        maxiter = options.pop("maxiter", None)
        x, _ = cg(self.A, b, x0=options.pop("x0", None), tol=tol, maxiter=maxiter)
        return np.asarray(x)


class GMRES:
    """Stateful GMRES wrapper."""

    def __init__(self, A) -> None:
        self.A = A

    def solve(self, b, **kwargs) -> np.ndarray:
        tol = kwargs.pop("rtol", kwargs.pop("tol", 1e-8))
        maxiter = kwargs.pop("maxiter", None)
        x, _ = gmres(self.A, b, x0=kwargs.pop("x0", None), tol=tol, maxiter=maxiter)
        return np.asarray(x)


class KSP:
    """Krylov solver facade with PETSc-KSP-like options.

    Supported approaches: "direct" (sparse LU), "cg", "gmres"; nullspace
    handling by projection.
    """

    def __init__(
        self,
        A,
        field_ises=None,
        nullspace: Optional[list] = None,
        appctx: Optional[dict] = None,
    ) -> None:
        self.A = sps.csr_matrix(A) if not sps.issparse(A) else A.tocsr()
        self.nullspace = (
            None if nullspace is None else [np.asarray(v) / np.linalg.norm(v) for v in nullspace]
        )
        self.options: dict = {"ksp_type": "gmres", "ksp_rtol": 1e-8}
        self._lu = None

    def setup(self, options: Optional[dict] = None) -> None:
        if options:
            # Flatten nested PETSc-style option dicts.
            flat = {}

            def _flatten(prefix, d):
                for k, v in d.items():
                    if isinstance(v, dict):
                        _flatten(f"{prefix}{k}_", v)
                    else:
                        flat[f"{prefix}{k}"] = v

            _flatten("", options)
            self.options.update(flat)

    def _project(self, v: np.ndarray) -> np.ndarray:
        if self.nullspace is None:
            return v
        for n in self.nullspace:
            v = v - (v @ n) * n
        return v

    def solve(self, b: np.ndarray, x0: Optional[np.ndarray] = None) -> np.ndarray:
        b = self._project(np.asarray(b, dtype=float))
        ksp_type = str(self.options.get("ksp_type", "gmres")).lower()
        rtol = float(self.options.get("ksp_rtol", 1e-8))
        maxiter = self.options.get("ksp_max_it", None)
        if ksp_type in ("preonly", "direct", "lu"):
            if self._lu is None:
                self._lu = sps.linalg.splu(self.A.tocsc())
            x = self._lu.solve(b)
        elif ksp_type == "cg":
            x, _ = sps.linalg.cg(self.A, b, x0=x0, rtol=rtol, maxiter=maxiter)
        else:
            x, _ = sps.linalg.gmres(self.A, b, x0=x0, rtol=rtol, maxiter=maxiter)
        return self._project(x)

    def kill(self) -> None:
        """Release factorizations (PETSc API parity)."""
        self._lu = None
