"""Beckmann-formulation Wasserstein-1 solvers (Newton / Bregman / G-prox).

Counterpart of :mod:`darsia_tpu.measure.beckmann` (reference
``src/darsia/measure/beckmann_problem.py``, ``beckmann_newton_solver.py``,
``beckmann_bregman_solver.py``, ``beckmann_gprox_solver.py``).

Problem:  inf ||u||_{L1}  s.t.  div u = m2 - m1   (TPFA finite volumes).

Fluxes are per-axis face arrays; divergence, the RT0 quadrature of |u|,
mobility averaging and the pressure Schur solve are stencil programs on
tensors (:mod:`beckmann_kernels`), on the device of the mass difference;
the constants (quadrature, face weights, DST eigenvalues, the polish's
inverse Laplacian) go to each device once.

Where the JAX package runs a solve as one device program (a
``lax.while_loop`` over iterations, used when the mobility is cell-based and
no callbacks or printing are asked for) or as a host loop otherwise, the
port has one Python loop that reads the iteration's five metrics
``[distance, increment^2, norm^2, residual, gap]`` once per iteration.  For
each option set it follows the path the JAX package takes: its stopping rule
(the device loop converges only from the third iteration and evaluates the
criteria in the solve's dtype; the host loop in float64), its handling of a
non-finite iterate (the device loop keeps the previous state and stops;
Newton's host loop does too; Bregman's and G-prox's host loops go on), its
Anderson variant (the tensor mixing inside the device loop, the numpy class
in the host loop) and its info dictionary.
"""

from __future__ import annotations

import time
from enum import Enum
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..image.image import as_tensor
from ..utils import tracing
from ..utils.andersonacceleration import AndersonAcceleration, anderson_init, anderson_mix
from ..utils.convergence_status import ConvergenceStatus
from ..utils.fv import face_to_cell, tangential_face_components
from ..utils.grid import Grid
from ..utils.quadrature import (
    gauss_reference_boundary,
    gauss_reference_cell,
    reference_cell_corners,
)
from . import beckmann_kernels as bk

__all__ = [
    "L1Mode",
    "MobilityMode",
    "BeckmannProblem",
    "BeckmannNewtonSolver",
    "BeckmannBregmanSolver",
    "BeckmannGproxPGHDSolver",
    "BeckmannConvergenceCriteria",
    "BeckmannConvergenceHistory",
    "ProjectedPoissonSolver",
]


def peak_device_memory_gb(device: torch.device) -> float:
    """Peak memory allocated on a CUDA ``device`` in GB; 0.0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    return float(torch.cuda.max_memory_allocated(device)) / 1e9


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(state) -> torch.device:
    """The device of the first tensor in a (nested) state."""
    while isinstance(state, (tuple, list)):
        state = next(x for x in state if x is not None)
    return state.device


def _select(keep: torch.Tensor, new, old):
    """Per problem of a batch, ``new`` where ``keep`` (``(B,)`` bool), else
    ``old``, through nested tuples of tensors with the batch leading."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select(keep, a, b) for a, b in zip(new, old))
    if new is None:
        return None
    return torch.where(keep.reshape(keep.shape + (1,) * (new.dim() - 1)), new, old)


class L1Mode(str, Enum):
    """Quadrature mode for the L1 dissipation."""

    RAVIART_THOMAS = "raviart_thomas"
    CONSTANT_SUBCELL_PROJECTION = "constant_subcell_projection"
    CONSTANT_CELL_PROJECTION = "constant_cell_projection"
    #: |RT0 flux| integrated over the cell boundary (face Gauss rules).
    FACE_QUADRATURE = "face_quadrature"


class MobilityMode(str, Enum):
    """Averaging mode for the face mobility."""

    CELL_BASED = "cell_based"
    CELL_BASED_ARITHMETIC = "cell_based_arithmetic"
    CELL_BASED_HARMONIC = "cell_based_harmonic"
    SUBCELL_BASED = "subcell_based"
    FACE_BASED = "face_based"


#: Mobility modes whose face weights the JAX package traces into its device
#: loops; the others send its solvers to their host loops.
_TRACEABLE_MOBILITY = (
    MobilityMode.CELL_BASED,
    MobilityMode.CELL_BASED_HARMONIC,
    MobilityMode.SUBCELL_BASED,
)


class BeckmannConvergenceCriteria:
    """Tolerance checks for the Beckmann iterations."""

    def __init__(
        self,
        num_iter: int = 100,
        tol_increment: float = np.finfo(float).max,
        tol_distance: float = np.finfo(float).max,
        tol_residual: float = np.finfo(float).max,
    ) -> None:
        self.num_iter = num_iter
        self.tol_increment = tol_increment
        self.tol_distance = tol_distance
        self.tol_residual = tol_residual

    def check_convergence_status(
        self, iter: int, increment: float, distance_increment: float, residual: float
    ) -> ConvergenceStatus:
        values = [increment, distance_increment, residual]
        if any(not np.isfinite(v) for v in values):
            return ConvergenceStatus.DIVERGED
        # All criteria must hold simultaneously (reference semantics).
        if (
            increment < self.tol_increment
            and distance_increment < self.tol_distance
            and residual < self.tol_residual
        ):
            return ConvergenceStatus.CONVERGED
        if iter >= self.num_iter - 1:
            return ConvergenceStatus.NOT_CONVERGED
        return ConvergenceStatus.IN_PROGRESS


class BeckmannConvergenceHistory:
    """Record of per-iteration convergence data."""

    def __init__(self) -> None:
        self.distance: list[float] = []
        self.distance_increment: list[float] = []
        self.residual: list[float] = []
        self.increment: list[float] = []
        self.duality_gap: list[float] = []
        self.timings: list[dict] = []
        self.total_run_time: list[float] = []

    def append(self, **kwargs) -> None:
        for key, value in kwargs.items():
            getattr(self, key).append(value)

    def as_dict(self) -> dict:
        return {
            "distance": self.distance,
            "distance_increment": self.distance_increment,
            "residual": self.residual,
            "increment": self.increment,
            "duality_gap": self.duality_gap,
            "timings": self.timings,
            "total_run_time": self.total_run_time,
        }


def _dst1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Unnormalized type-I DST along ``axis`` (odd extension + FFT).

    DST-I is involutive up to 2/(m+1); eigenvectors of any symmetric Toeplitz
    tridiagonal matrix are its sine modes.
    """
    m = x.shape[axis]
    zshape = list(x.shape)
    zshape[axis] = 1
    z0 = x.new_zeros(zshape)
    z = torch.cat([z0, x, z0, -torch.flip(x, [axis])], dim=axis)
    return -0.5 * torch.fft.fft(z, dim=axis).imag.narrow(axis, 1, m)


def _tridiagonal_inverse_eigs(qp_h, qw_h, shape, power: int, floor: float, what: str):
    """Per axis, 1/eigenvalues of the symmetric Toeplitz tridiagonal matrix
    tridiag(b, a + c, b) of the quadrature moments a = sum w^p t^2,
    b = sum w^p t (1 - t), c = sum w^p (1 - t)^2 (float64, host)."""
    out = []
    for d in range(len(shape)):
        t = qp_h[:, d]
        w = qw_h**power
        a_d = float(np.sum(w * t * t))
        b_d = float(np.sum(w * t * (1.0 - t)))
        c_d = float(np.sum(w * (1.0 - t) ** 2))
        m = shape[d] - 1
        k = np.arange(1, m + 1)
        lam = (a_d + c_d) + 2.0 * b_d * np.cos(np.pi * k / (m + 1))
        # A degenerate rule (all points at t = 0.5) drives lam -> 0; once a
        # clamp engages the solve is no longer the exact inverse, the
        # pairing identity breaks and the lower-bound guarantee is lost:
        # fail loudly instead.
        if lam.size and float(lam.min()) <= floor:
            raise ValueError(what.format(d=d, lam=float(lam.min())))
        out.append(1.0 / lam)
    return out


class BeckmannProblem:
    """Shared setup of the TPFA Beckmann problem."""

    def __init__(
        self,
        grid: Grid,
        weight=None,
        options: dict = {},
    ) -> None:
        self.grid = grid
        self.dim = grid.dim
        self.shape = tuple(grid.shape)
        self.voxel_size = grid.voxel_size
        self.cell_vol = float(np.prod(grid.voxel_size))
        self.face_vol = tuple(float(v) for v in grid.face_vol)
        self.options = options
        self.regularization = float(options.get("regularization", np.finfo(float).eps))
        self.verbose = options.get("verbose", False)
        self.mobility_mode = MobilityMode(
            options.get("mobility_mode", MobilityMode.CELL_BASED)
        )
        self.callbacks = options.get("callbacks", None)

        # Precision: float32 by default, float64 on request (no global flag
        # needed, unlike the JAX package's jax_enable_x64).
        requested = str(options.get("dtype", "float32"))
        self.dtype = (
            torch.float64 if requested in ("float64", "f64", "double") else torch.float32
        )
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32

        # Cell weights: a tensor weight stays a tensor (its copies per
        # device are made on use), a numpy weight stays on the host until a
        # solve puts it on the mass difference's device.
        self.weight = weight
        if weight is None:
            self.cell_weights = 1.0
        else:
            data = weight.img if hasattr(weight, "img") else weight
            self.cell_weights = (
                data.detach().to(self.dtype)
                if isinstance(data, torch.Tensor)
                else np.asarray(data, dtype=np_dtype)
            )
        self.device = (
            self.cell_weights.device if isinstance(self.cell_weights, torch.Tensor) else None
        )

        # L1 quadrature (host numpy in the solve's dtype, as the JAX package
        # rounds it).
        l1_mode = L1Mode(options.get("l1_mode", L1Mode.RAVIART_THOMAS))
        l1_order = options.get("l1_order", "max")
        if l1_mode == L1Mode.RAVIART_THOMAS:
            quad_pts, quad_weights = gauss_reference_cell(self.dim, l1_order)
        elif l1_mode == L1Mode.CONSTANT_SUBCELL_PROJECTION:
            quad_pts, quad_weights = reference_cell_corners(self.dim)
        elif l1_mode == L1Mode.FACE_QUADRATURE:
            quad_pts, quad_weights = gauss_reference_boundary(self.dim, l1_order)
        else:
            quad_pts, quad_weights = gauss_reference_cell(self.dim, 0)
        self.quad_pts = np.atleast_2d(quad_pts).astype(np_dtype)
        self.quad_weights = np.asarray(quad_weights).astype(np_dtype)

        # Anderson acceleration on the flux (host loops: the numpy class,
        # sized on first use; device loops: anderson_mix).
        aa_depth = options.get("aa_depth", 0)
        aa_restart = options.get("aa_restart", None)
        self.aa_depth = int(aa_depth)
        self.aa_restart = aa_restart
        self.anderson = (
            AndersonAcceleration(dimension=None, depth=aa_depth, restart=aa_restart)
            if aa_depth > 0
            else None
        )

        self.cg_tol = options.get("linear_solver_options", {}).get("rtol", 1e-6)
        self.cg_maxiter = options.get("linear_solver_options", {}).get(
            "maxiter", 10 * int(np.max(self.shape))
        )
        # Linear solver: "cg" = Jacobi-PCG, "amg"/"mg" = geometric multigrid
        # PCG, "auto" = MG where Jacobi-CG iteration counts start growing
        # (>= 64 cells on the smallest axis).
        solver_name = str(options.get("linear_solver", "auto")).lower()
        if solver_name in ("amg", "mg"):
            self._use_mg = True
        elif solver_name in ("cg", "jacobi", "jacobi-cg", "direct"):
            self._use_mg = False
        else:
            self._use_mg = int(np.min(self.shape)) >= 64
        self._mg_levels = bk.tpfa_mg_levels(self.shape) if self._use_mg else 1
        self._mg_maxiter = min(self.cg_maxiter, 200)

        # Quadrature-consistent dual certificate.  The primal pairing
        # sum_{c,q} V w_q <RT0(ghat)(t_q), RT0(u)(t_q)> reduces per axis to
        # the constant-coefficient tridiagonal mass matrix
        # M_d = tridiag(b_d, a_d + c_d, b_d) of the ACTUAL quadrature rule, so
        # p^T B u = sum_{c,q} V w_q <ghat_q, (A_q u)_c> with
        # ghat_d = (V M_d)^{-1} (B^T p)_d holds exactly.  M_d has the sine
        # modes as eigenbasis: its inverse costs two DST-I (FFTs) per axis.
        # The exact-gauge certificate needs F F^T, the same structure with
        # the w_q^2 moments.
        qp_h = self.quad_pts.astype(np.float64)
        qw_h = self.quad_weights.astype(np.float64)
        self._mass_inv_eigs = _tridiagonal_inverse_eigs(
            qp_h,
            qw_h,
            self.shape,
            1,
            1e-9,
            "Quadrature mass matrix is numerically singular along axis {d} (min "
            "eigenvalue {lam:.3e}); the dual certificate requires a non-degenerate rule.",
        )
        self._mass2_inv_eigs = _tridiagonal_inverse_eigs(
            qp_h,
            qw_h,
            self.shape,
            2,
            1e-12,
            "Quadrature representer matrix singular along axis {d}; the "
            "exact-gauge certificate needs a non-degenerate rule.",
        )
        self._qw_host = [float(v) for v in qw_h]
        self._constants_by_device: dict = {}

    # ------------------------------------------------------------ constants

    def _constants(self, device) -> SimpleNamespace:
        """Device copies of the problem's constants, made once per device."""
        device = torch.device(device)
        key = str(device)
        if key in self._constants_by_device:
            return self._constants_by_device[key]
        dt = dict(dtype=self.dtype, device=device)
        c = SimpleNamespace()
        c.qp = torch.tensor(self.quad_pts, **dt)
        c.qw = torch.tensor(self.quad_weights, **dt)
        if isinstance(self.cell_weights, float):
            c.w = 1.0
            c.w_full = torch.ones(self.shape, **dt)
            c.base_face_weights = tuple(
                torch.ones(self.grid.faces_shape[d], **dt) for d in range(self.dim)
            )
        else:
            c.w = torch.as_tensor(self.cell_weights).to(**dt)
            c.w_full = c.w
            c.w_sq = c.w**2
            inv = bk.harmonic_face_average(1.0 / c.w, self.dim)
            c.base_face_weights = tuple(1.0 / f for f in inv)
        c.mass_inv = [torch.tensor(e, **dt) for e in self._mass_inv_eigs]
        c.mass2_inv = [torch.tensor(e, **dt) for e in self._mass2_inv_eigs]
        c.qw_vol = torch.tensor([self.cell_vol * q for q in self._qw_host], **dt)
        c.blur = {}
        c.polish = None
        self._constants_by_device[key] = c
        return c

    # ------------------------------------------------------ kernel closures

    def transport_density(self, fluxes: tuple, weighted: bool = True) -> torch.Tensor:
        c = self._constants(fluxes[0].device)
        return bk.transport_density_cells(
            fluxes, c.qp, c.qw, c.w if weighted else 1.0, self.shape, self.dim
        )

    def _cell_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the grid axes: 0-d, or one per problem of a leading batch
        axis (``batched_wasserstein``)."""
        if x.dim() == self.dim:
            return torch.sum(x)
        return torch.sum(x, dim=tuple(range(-self.dim, 0)))

    def _l1(self, fluxes: tuple) -> torch.Tensor:
        return self.cell_vol * self._cell_sum(self.transport_density(fluxes))

    def flux_from_pressure(self, face_weights: tuple, p: torch.Tensor) -> tuple:
        grad = bk.pressure_gradient_faces(p, self.face_vol, self.dim)
        return tuple(g / (face_weights[d] * self.cell_vol) for d, g in enumerate(grad))

    def _cell_inverse_mobility(self, rho: torch.Tensor, c) -> torch.Tensor:
        return rho / (c.w**2) if isinstance(c.w, float) else rho / c.w_sq

    def _cell_based_face_weights(self, fluxes: tuple) -> tuple:
        c = self._constants(fluxes[0].device)
        rho = bk.transport_density_cells(fluxes, c.qp, c.qw, c.w, self.shape, self.dim)
        peak = (
            torch.max(rho)
            if rho.dim() == self.dim
            else torch.amax(rho, dim=tuple(range(-self.dim, 0)), keepdim=True)
        )
        floor = torch.clamp(1e-6 * peak, min=self.regularization)
        rho = torch.maximum(rho, floor)
        inv = bk.harmonic_face_average(self._cell_inverse_mobility(rho, c), self.dim)
        return tuple(1.0 / torch.clamp(f, min=1e-30) for f in inv)

    def _residual(self, fluxes, p, fw, mass_rhs, distance) -> torch.Tensor:
        div = bk.face_divergence(fluxes, self.face_vol, self.dim)
        div_res_sq = self._cell_sum((div - mass_rhs) ** 2)
        grad = bk.pressure_gradient_faces(p, self.face_vol, self.dim)
        if isinstance(distance, torch.Tensor):
            distance = bk.per_pair(distance, self.dim)
        flux_res_sq = 0.0
        for d in range(self.dim):
            res = (self.cell_vol * fw[d] * fluxes[d] - grad[d]) / distance
            flux_res_sq = flux_res_sq + self._cell_sum(res**2)
        return torch.sqrt(flux_res_sq + div_res_sq)

    # ---------------------------------------------------- dual certificate

    def _mass_solve(self, gd: torch.Tensor, d: int, eigs: list) -> torch.Tensor:
        """Exact solve of the axis-``d`` tridiagonal system (DST-I twice)."""
        m = gd.shape[-self.dim + d]
        eig_shape = [m if i == d else 1 for i in range(self.dim)]
        spec = _dst1(gd, gd.dim() - self.dim + d) * eigs[d].reshape(eig_shape)
        return _dst1(spec, gd.dim() - self.dim + d) * (2.0 / (m + 1))

    def _ghat(self, p: torch.Tensor, c) -> tuple:
        g = bk.pressure_gradient_faces(p, self.face_vol, self.dim)
        return tuple(
            self._mass_solve(g[d], d, c.mass_inv) / self.cell_vol for d in range(self.dim)
        )

    def _ratio(self, cell_vectors: torch.Tensor, c) -> torch.Tensor:
        """max over points and cells of |vector| / w (per problem of a batch:
        ``cell_vectors`` is ``(nq, *lead, *shape, dim)``)."""
        norms = torch.linalg.vector_norm(cell_vectors, dim=-1)
        ratios = norms if isinstance(c.w, float) else norms / c.w
        if ratios.dim() == self.dim + 1:
            return torch.max(ratios)
        return torch.amax(ratios, dim=(0,) + tuple(range(-self.dim, 0)))

    def _dual_value(self, p: torch.Tensor, mass_rhs: torch.Tensor) -> torch.Tensor:
        """Certified dual (Kantorovich) value from a potential iterate.

        The dual of min sum_{c,q} V w_q ||w_c (A_q u)_c|| s.t. B u = f is
        max <p, f> over p whose induced face gradient is dual-feasible.  Here
        ghat = (V M)^{-1} B^T p makes the pairing identity exact, feasibility
        ||RT0(ghat)(t_q)|| <= w_c is checked at the quadrature points the
        primal integrates, and the iterate is rescaled exactly onto the
        feasibility boundary: the value is a true lower bound on the discrete
        optimum, and distance - dual certifies the distance.  |.| handles the
        sign convention (-p is feasible whenever p is).
        """
        c = self._constants(p.device)
        gq = bk.face_to_cell_pt(self._ghat(p, c), c.qp, self.shape, self.dim)
        ratio = self._ratio(gq, c)
        return torch.abs(self._cell_sum(p * mass_rhs)) / torch.clamp(ratio, min=1e-30)

    def _mirror_blur(self, p: torch.Tensor, sigma: float) -> torch.Tensor:
        """Gaussian blur of width ``sigma`` cells via mirror-extended FFT (the
        even extension keeps opposite edges apart; cost independent of
        sigma).  The spectral factors are made once per device and width."""
        c = self._constants(p.device)
        ext = p
        for d in range(self.dim):
            ext = torch.cat([ext, torch.flip(ext, [d])], dim=d)
        if sigma not in c.blur:
            factors = []
            for d in range(self.dim):
                f = torch.fft.fftfreq(ext.shape[d], dtype=self.dtype, device=p.device)
                fshape = [-1 if i == d else 1 for i in range(self.dim)]
                factors.append(
                    torch.exp(-2.0 * (np.pi * sigma) ** 2 * f * f).reshape(fshape)
                )
            c.blur[sigma] = factors
        spec = torch.fft.fftn(ext)
        for factor in c.blur[sigma]:
            spec = spec * factor
        out = torch.fft.ifftn(spec).real.to(p.dtype)
        return out[tuple(slice(0, s) for s in p.shape)]

    def _dual_value_best(self, p: torch.Tensor, mass_rhs: torch.Tensor) -> torch.Tensor:
        """Max of the certified dual over a sweep of blur widths.

        The exact discrete potential carries O(h) oscillations near the
        transport support whose gradient overshoots the constraint; the
        sup-norm rescale then punishes the whole value for a local spike.
        Every blurred copy of p still yields a valid lower bound.
        """
        best = self._dual_value(p, mass_rhs)
        for sigma in (1.0, 2.0, 4.0, 8.0, 16.0):
            best = torch.maximum(best, self._dual_value(self._mirror_blur(p, sigma), mass_rhs))
        return best

    # Exact-gauge certificate: free quadrature representatives.  The exact
    # dual feasibility of g = B^T p only needs SOME per-(cell, q) field Z with
    #     F Z := V sum_q w_q A_q^T z_q = g,   ||z_q(c)|| <= w_c,
    # a larger feasible set than the face-parameterized one of _dual_value.
    # F F^T is per-axis symmetric Toeplitz tridiagonal (the w_q^2 moments),
    # so projecting onto the affine set {F Z = g} is exact; alternating
    # projections (balls <-> affine) drive max ||z_q(c)|| / w_c down to the
    # true gauge, and every affine-feasible iterate certifies
    # |<p, f>| / ratio as a lower bound.

    def _F(self, Z: torch.Tensor, c) -> tuple:
        """F Z = V sum_q w_q A_q^T z_q (per-axis face arrays)."""
        Zw = Z * c.qw.reshape((-1,) + (1,) * (self.dim + 1))
        return tuple(
            self.cell_vol * f for f in bk.face_to_cell_pt_adjoint(Zw, c.qp, self.dim)
        )

    def _Ft_scaled(self, lam: tuple, c) -> torch.Tensor:
        """F^T (F F^T)^{-1} applied to ``lam``, already mass2-solved / V^2."""
        cells = bk.face_to_cell_pt(lam, c.qp, self.shape, self.dim)
        return c.qw_vol.reshape((-1,) + (1,) * (self.dim + 1)) * cells

    def _affine_project(self, Z: torch.Tensor, g: tuple, c) -> torch.Tensor:
        r = self._F(Z, c)
        vol2 = self.cell_vol * self.cell_vol
        corr = tuple(
            self._mass_solve(r[d] - g[d], d, c.mass2_inv) / vol2 for d in range(self.dim)
        )
        return Z - self._Ft_scaled(corr, c)

    def _gauge_ratio(self, Z: torch.Tensor, c) -> torch.Tensor:
        norms = torch.linalg.vector_norm(Z, dim=-1)
        return torch.max(norms / c.w_full[None])

    def _gauge_block(self, Z: torch.Tensor, g: tuple, radius: float, iters: int):
        """``iters`` POCS steps at ball radius ``radius * w``.

        POCS converges to an intersection point when one exists (gauge <=
        radius), so the affine iterate's ratio approaches the radius from
        above; shrinking the radius toward the best ratio (the schedule of
        :meth:`dual_value_exact`) descends to the true gauge.
        """
        c = self._constants(Z.device)
        scale = radius * c.w_full[None, ..., None]
        for _ in range(iters):
            nrm = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
            Zc = Z * torch.clamp(scale / torch.clamp(nrm, min=1e-30), max=1.0)
            Z = self._affine_project(Zc, g, c)
        return Z, self._gauge_ratio(Z, c)

    def _gauge_init(self, p: torch.Tensor):
        c = self._constants(p.device)
        g = bk.pressure_gradient_faces(p, self.face_vol, self.dim)
        vol2 = self.cell_vol * self.cell_vol
        c0 = tuple(self._mass_solve(g[d], d, c.mass2_inv) / vol2 for d in range(self.dim))
        Z = self._Ft_scaled(c0, c)
        return g, Z, self._gauge_ratio(Z, c)

    def _polish_operators(self, device) -> SimpleNamespace:
        """Laplacian-preconditioned Chambolle-Pock ascent on the certified
        dual, built once per device.

        Solves max <p, f> s.t. A p in the per-cell weight-ball product, where
        A p is the quadrature-point interpolant of the mass-solved gradient
        (the feasible set of ``_dual_value``).  Any iterate evaluated through
        the exact certificate stays a valid lower bound, so the polish can
        only tighten the certificate.  The potential step is preconditioned
        with a spectral (DCT-II, Neumann) inverse Laplacian, which keeps the
        step O(1).  ``A``'s transpose is written out: the quadrature
        interpolant's adjoint slices where it padded, the DST mass solve is
        symmetric, and the gradient's adjoint is the divergence.
        """
        c = self._constants(device)
        if c.polish is not None:
            return c.polish
        dim, shape = self.dim, self.shape
        cdtype = torch.complex128 if self.dtype == torch.float64 else torch.complex64

        def A(p):
            return bk.face_to_cell_pt(self._ghat(p, c), c.qp, shape, dim)

        def At(z):
            faces = bk.face_to_cell_pt_adjoint(z, c.qp, dim)
            ghat_t = tuple(
                self._mass_solve(faces[d], d, c.mass_inv) / self.cell_vol
                for d in range(dim)
            )
            return bk.face_divergence(ghat_t, self.face_vol, dim)

        phases = []
        for d in range(dim):
            m = shape[d]
            k = np.arange(m)
            pshape = [m if i == d else 1 for i in range(dim)]
            fwd = torch.tensor(np.exp(-1j * np.pi * k / (2 * m)), dtype=cdtype, device=device)
            inv = torch.tensor(np.exp(1j * np.pi * k / (2 * m)), dtype=cdtype, device=device)
            phases.append((fwd.reshape(pshape), inv.reshape(pshape)))

        def dct2e(x, axis):
            """DCT-II along ``axis`` via the mirrored-FFT identity."""
            m = x.shape[axis]
            spec = torch.fft.fft(torch.cat([x, torch.flip(x, [axis])], dim=axis), dim=axis)
            return (spec.narrow(axis, 0, m) * phases[axis][0]).real

        def idct2e(X, axis):
            m = X.shape[axis]
            Xc = X.to(cdtype) * phases[axis][1]
            zshape = list(X.shape)
            zshape[axis] = 1
            spec = torch.cat(
                [
                    Xc,
                    Xc.new_zeros(zshape),
                    torch.conj(torch.flip(Xc.narrow(axis, 1, m - 1), [axis])),
                ],
                dim=axis,
            )
            return torch.fft.ifft(spec, dim=axis).real.narrow(axis, 0, m)

        # Neumann (cell-centred) Laplacian eigenvalues in the DCT-II basis.
        lap = np.zeros(shape)
        for d in range(dim):
            m = shape[d]
            k = np.arange(m)
            lam_d = (2.0 - 2.0 * np.cos(np.pi * k / m)) / self.voxel_size[d] ** 2
            lap = lap + lam_d.reshape([m if i == d else 1 for i in range(dim)])
        lap_inv_np = 1.0 / np.maximum(lap, 1e-30)
        lap_inv_np[tuple([0] * dim)] = 0.0  # project out the constant mode
        lap_inv = torch.tensor(lap_inv_np, dtype=self.dtype, device=device)

        def K(r):
            spec = r
            for d in range(dim):
                spec = dct2e(spec, d)
            spec = spec * lap_inv
            for d in reversed(range(dim)):
                spec = idct2e(spec, d)
            return spec

        # Step size from a deterministic power iteration on K A^T A.
        rng = np.random.default_rng(0)
        v = torch.tensor(rng.standard_normal(shape), dtype=self.dtype, device=device)
        for _ in range(30):
            v = K(At(A(v)))
            v = v / torch.linalg.vector_norm(v)
        op_norm_sq = float(torch.linalg.vector_norm(K(At(A(v)))))
        step = 0.9 / float(np.sqrt(max(op_norm_sq, 1e-30)))
        c.polish = SimpleNamespace(A=A, At=At, K=K, step=step)
        return c.polish

    def _polish_chunk(self, carry: tuple, mass_rhs: torch.Tensor, iters: int) -> tuple:
        """``iters`` Chambolle-Pock steps from an explicit (p, pbar, z) carry:
        an adaptive caller certifies after every chunk WITHOUT restarting
        the dual variable z (a restart throws away the accumulated averaging
        and stalls the ascent)."""
        ops = self._polish_operators(mass_rhs.device)
        c = self._constants(mass_rhs.device)
        step = ops.step
        w = c.w_full[None, ..., None]
        p, pbar, z = carry
        for _ in range(iters):
            y = z + step * ops.A(pbar)
            vq = y / step
            nrm = torch.linalg.vector_norm(vq, dim=-1, keepdim=True)
            proj = vq * torch.clamp(w / torch.clamp(nrm, min=1e-30), max=1.0)
            z = y - step * proj
            p_new = p - step * ops.K(ops.At(z) - mass_rhs)
            p, pbar = p_new, 2.0 * p_new - p
        return p, pbar, z

    def _polish_z0(self, device) -> torch.Tensor:
        nq = self.quad_pts.shape[0]
        return torch.zeros((nq,) + self.shape + (self.dim,), dtype=self.dtype, device=device)

    def _as_field(self, array, device=None) -> torch.Tensor:
        """A grid field as a tensor of the solve's dtype: a tensor stays on
        its device, numpy goes to ``device`` (the card when None)."""
        return as_tensor(array, device).to(self.dtype)

    def dual_value(self, pressure, mass_diff, refine: bool = False) -> float:
        """Certified dual objective: a true lower bound on the discrete W1
        distance from any potential iterate (see ``_dual_value``); with
        ``refine`` the bound is tightened over a blur sweep."""
        p = self._as_field(pressure)
        mass_rhs = self.cell_vol * self._as_field(mass_diff, p.device)
        fn = self._dual_value_best if refine else self._dual_value
        return float(fn(p, mass_rhs))

    def dual_value_exact(
        self, pressure, mass_diff, rounds: int = 12, block: int = 100
    ) -> float:
        """Exact-gauge certified dual value of a potential iterate.

        The true dual gauge of ``B^T p`` over all free per-quadrature-point
        representatives (not just the face-parameterized family
        ``_dual_value`` checks), by a shrinking-radius POCS schedule on the
        affine representer set (one host read per round).  Always >= the
        restricted certificate; every value stays a strict lower bound.
        """
        p = self._as_field(pressure)
        mass_rhs = self.cell_vol * self._as_field(mass_diff, p.device)
        g, Z, r0 = self._gauge_init(p)
        best = float(r0)
        radius = best * 0.95
        for _ in range(int(rounds)):
            Z, ratio = self._gauge_block(Z, g, radius, int(block))
            ratio = float(ratio)
            if ratio < best:
                best = ratio
            if ratio <= radius * 1.002:
                radius = min(best * 0.99, radius * 0.95)  # feasible: shrink
            else:
                radius = 0.5 * (radius + best)  # infeasible: back off
        pf = abs(float(torch.sum(p * mass_rhs)))
        return pf / max(best, 1e-30)

    def duality_gap(
        self,
        fluxes,
        pressure,
        mass_diff,
        refine: bool = True,
        polish_iters: int = 0,
        polish_target: Optional[float] = None,
        polish_max_iters: int = 30000,
    ) -> float:
        """Relative primal-dual gap (distance - dual)/distance: the
        optimality certificate of the reported distance.

        With ``polish_iters`` > 0 the preconditioned Chambolle-Pock dual
        ascent runs from the given potential and the best certified value is
        kept.  With ``polish_target`` set, the ascent continues in
        ``polish_iters`` chunks (the carry persists across chunks) until the
        certified gap reaches the target, the ascent stalls (< 3% relative
        gap improvement per chunk), or ``polish_max_iters`` steps ran.
        """
        distance = self.l1_dissipation(fluxes)
        dual = self.dual_value(pressure, mass_diff, refine=refine)
        if polish_iters > 0:
            p0 = self._as_field(pressure)
            mass_rhs = self.cell_vol * self._as_field(mass_diff, p0.device)
            carry = (p0, p0, self._polish_z0(p0.device))
            chunk = int(polish_iters)
            total = 0
            while True:
                carry = self._polish_chunk(carry, mass_rhs, chunk)
                total += chunk
                val = float(self._dual_value_best(carry[0], mass_rhs))
                prev_gap = (distance - dual) / max(distance, 1e-30)
                dual = max(dual, val)
                gap = (distance - dual) / max(distance, 1e-30)
                if polish_target is None or total >= int(polish_max_iters):
                    break
                if gap <= polish_target:
                    break
                if prev_gap - gap < 0.03 * max(prev_gap, 1e-30):
                    break  # stalled: more ascent will not certify tighter
            # Final tightening: exact-gauge certification of the polished
            # potential (free representatives certify >= the restricted family).
            dual = max(dual, self.dual_value_exact(carry[0], mass_diff))
        return (distance - dual) / max(distance, 1e-30)

    # ------------------------------------------------------ flux utilities

    def zero_fluxes(self, device=None) -> tuple:
        """Zero face arrays on ``device`` (the CUDA card when None)."""
        device = "cuda" if device is None else device
        return tuple(
            torch.zeros(self.grid.faces_shape[d], dtype=self.dtype, device=device)
            for d in range(self.dim)
        )

    def flat_flux(self, fluxes: tuple) -> torch.Tensor:
        """The grid's flat (Fortran-order) face vector, on the fluxes' device."""
        return self.grid.flat_flux(list(fluxes))

    def _flatten_fluxes(self, fluxes: tuple) -> torch.Tensor:
        """Flat C-order view of the per-axis face arrays (the Anderson mixing
        is invariant to the fixed flattening order)."""
        return torch.cat([f.reshape(-1) for f in fluxes])

    def _unflatten_fluxes(self, flat: torch.Tensor) -> tuple:
        out, off = [], 0
        for d in range(self.dim):
            size = int(np.prod(self.grid.faces_shape[d]))
            out.append(flat[off : off + size].reshape(self.grid.faces_shape[d]))
            off += size
        return tuple(out)

    # -- reference-surface adapters.  The reference's BeckmannProblem is a
    # scipy.sparse machine (DOF manager, assembled div/mass matrices, Schur
    # eliminations); here the same API works on flat (ndofs,) vectors and
    # stencil closures.

    @property
    def ndofs(self) -> int:
        """Total flux + pressure DOF count."""
        num_faces = sum(int(np.prod(self.grid.faces_shape[d])) for d in range(self.dim))
        return num_faces + int(np.prod(self.shape))

    def flux_view(self, flat) -> tuple:
        """Per-axis face arrays from a flat (ndofs,) vector's flux block."""
        num_faces = self.ndofs - int(np.prod(self.shape))
        return self._unflatten_fluxes(as_tensor(flat)[:num_faces])

    def pressure_view(self, flat) -> torch.Tensor:
        """Cell pressure array from a flat (ndofs,) vector."""
        num_faces = self.ndofs - int(np.prod(self.shape))
        return as_tensor(flat)[num_faces:].reshape(self.shape)

    def flat_view(self, fluxes: tuple, pressure: torch.Tensor) -> torch.Tensor:
        """Flat (ndofs,) vector [flux block, pressure block]."""
        return torch.cat([self._flatten_fluxes(fluxes), pressure.reshape(-1)])

    def transport_density_faces(self, fluxes: tuple) -> tuple:
        """Per-axis face flux magnitudes |u|."""
        return tuple(torch.abs(f) for f in fluxes)

    def cell_weighted_flux(self, fluxes: tuple) -> torch.Tensor:
        """Cell-centred weighted flux magnitude (the weighted transport
        density field)."""
        return self.transport_density(fluxes, weighted=True)

    def optimality_conditions(self, fluxes, pressure, mass_rhs) -> float:
        """Residual norm of the (rescaled-flux + divergence) optimality
        system."""
        face_weights = self.compute_face_weights(fluxes)
        return self.residual_norms(fluxes, pressure, face_weights, mass_rhs)

    rescaled_flux_optimality_conditions = optimality_conditions

    def distance_matrix(self, images: list) -> np.ndarray:
        """Symmetric N x N matrix of pairwise W1 distances (scalar returns
        whatever ``return_info`` says)."""
        n = len(images)
        matrix = np.zeros((n, n), dtype=float)
        saved = self.options
        self.options = {**saved, "return_info": False, "return_status": False}
        try:
            for i in range(n):
                for j in range(i + 1, n):
                    matrix[i, j] = float(self(images[i], images[j]))
                    matrix[j, i] = matrix[i, j]
        finally:
            self.options = saved
        return matrix

    def l1_dissipation(self, fluxes: tuple) -> float:
        return float(self._l1(fluxes))

    def _face_flux_norms(self, fluxes: tuple) -> list:
        """|full flux| on every face (normal + reconstructed tangential
        components), per axis, on the fluxes' device."""
        tangential = tangential_face_components(list(fluxes), self.shape)
        norms = []
        for d in range(self.dim):
            components = list(tangential[d])
            components.insert(d, fluxes[d])
            norms.append(torch.linalg.vector_norm(torch.stack(components, dim=-1), dim=-1))
        return norms

    def compute_face_weights(self, fluxes: tuple) -> tuple:
        """Face mobility weights 1/|u| via the configured averaging mode.

        The regularization floor is adaptive: at least 1e-6 of the maximal
        flux norm, keeping the weight contrast within float32 range.  The
        face-based mode reconstructs the full flux on the fluxes' device in
        the solve's dtype (the JAX package: on the host in float64).
        """
        if self.mobility_mode in _TRACEABLE_MOBILITY:
            return self._cell_based_face_weights(fluxes)
        c = self._constants(fluxes[0].device)
        if self.mobility_mode == MobilityMode.CELL_BASED_ARITHMETIC:
            harm = bk.harmonic_face_average(c.w_full, self.dim)
            rho = self.transport_density(fluxes)
            reg = torch.clamp(1e-6 * torch.max(rho), min=self.regularization)
            cell_inv = self._cell_inverse_mobility(torch.maximum(rho, reg), c)
            mean_w = c.w if isinstance(c.w, float) else c.w.mean()
            arith = []
            for d in range(self.dim):
                n = cell_inv.shape[d]
                a = cell_inv.narrow(d, 0, n - 1)
                b = cell_inv.narrow(d, 1, n - 1)
                arith.append(0.5 * (a + b) / mean_w)
            return tuple(h / a for h, a in zip(harm, arith))
        if self.mobility_mode == MobilityMode.FACE_BASED:
            norms = self._face_flux_norms(fluxes)
            peak = torch.max(torch.stack([n.max() for n in norms]))
            reg = torch.clamp(1e-6 * peak, min=self.regularization)
            return tuple(1.0 / torch.maximum(n, reg) for n in norms)
        raise ValueError(f"Mobility mode {self.mobility_mode} not supported.")

    # -- matrix-free saddle-system seams (the reference assembles sparse
    # blocks and Gauss-eliminates them; here stencil closures on flat (ndofs,)
    # vectors, and the eliminations return operator + rhs pairs).

    def broken_darcy_with_custom_flux_block(self, flux_block: tuple):
        """Saddle operator [[W, -G], [D, 0]] with a given diagonal flux block
        W (per-axis face arrays), as a closure on flat (ndofs,) vectors.  The
        reference's Lagrange-multiplier row is the mean-zero pressure gauge
        here."""

        def apply(flat):
            fluxes = self.flux_view(flat)
            p = self.pressure_view(flat)
            grad = bk.pressure_gradient_faces(p, self.face_vol, self.dim)
            flux_rows = tuple(flux_block[d] * fluxes[d] - grad[d] for d in range(self.dim))
            div_row = bk.face_divergence(fluxes, self.face_vol, self.dim)
            return self.flat_view(flux_rows, div_row)

        return apply

    def exact_linearization(self, solution):
        """Matrix-free exact linearization at ``solution`` (weight-diagonal
        flux block from the current face weights)."""
        fluxes = self.flux_view(solution)
        face_weights = self.compute_face_weights(fluxes)
        flux_block = tuple(self.cell_vol * face_weights[d] for d in range(self.dim))
        return self.broken_darcy_with_custom_flux_block(flux_block)

    def eliminate_flux(self, face_weights: tuple, flux_residual: tuple, div_residual) -> tuple:
        """Schur-complement elimination of the (diagonal) flux block.
        Returns the reduced operator (the weighted TPFA pressure stencil),
        the reduced rhs ``div_res - D J^-1 flux_res``, and the per-axis
        inverse flux diagonal ``J^-1 = 1/(cell_vol * fw)``."""
        flux_inv = tuple(1.0 / (self.cell_vol * face_weights[d]) for d in range(self.dim))
        trans = self.transmissibilities(face_weights)
        device = face_weights[0].device

        def schur_apply(p):
            return bk.tpfa_apply(
                self._as_field(p, device).reshape(self.shape), trans, self.dim
            )

        reduced_rhs = self._as_field(div_residual, device) - bk.face_divergence(
            tuple(flux_inv[d] * flux_residual[d] for d in range(self.dim)),
            self.face_vol,
            self.dim,
        )
        return schur_apply, reduced_rhs, flux_inv

    def eliminate_lagrange_multiplier(self, reduced_jacobian, reduced_residual):
        """Fix the pressure gauge of the reduced system: the rhs projected
        onto the mean-zero compatibility space of the singular TPFA
        operator."""
        rhs = as_tensor(reduced_residual)
        return reduced_jacobian, rhs - torch.mean(rhs)

    def linear_solve(
        self,
        face_weights: tuple,
        rhs,
        previous_solution=None,
        reuse_solver: bool = False,
    ) -> tuple:
        """Solve the Schur-reduced pressure system and report timings
        (device-synchronised; the stencil path has no factorization, so the
        set-up is the right-hand side's preparation)."""
        device = face_weights[0].device
        tic = time.perf_counter()
        rhs = self._as_field(rhs, device).reshape(self.shape)
        rhs = rhs - torch.mean(rhs)
        p0 = (
            torch.zeros(self.shape, dtype=self.dtype, device=device)
            if previous_solution is None
            else self._as_field(previous_solution, device).reshape(self.shape)
        )
        _synchronize(device)
        time_setup = time.perf_counter() - tic
        tic = time.perf_counter()
        solution = self.pressure_solve(face_weights, rhs, p0)
        _synchronize(device)
        time_solve = time.perf_counter() - tic
        return solution, {"time_setup": time_setup, "time_solve": time_solve}

    # --------------------------------------------------------- subproblems

    def transmissibilities(self, face_weights: tuple) -> tuple:
        """Per-face transmissibilities of the pressure Schur operator."""
        return tuple(
            (self.face_vol[d] ** 2) / (face_weights[d] * self.cell_vol)
            for d in range(self.dim)
        )

    def _time_phase(self, fn, args, reps: int = 5) -> float:
        """Steady-state seconds of one phase (device-synchronised)."""

        def device_of(out):
            while isinstance(out, (tuple, list)):
                out = out[0]
            return out.device

        _synchronize(device_of(fn(*args)))  # warm-up
        tic = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _synchronize(device_of(out))
        return (time.perf_counter() - tic) / reps

    def profile_phases(self, mass_diff, reps: int = 5) -> dict:
        """Measured per-phase seconds of one solver iteration (each phase
        re-run alone at steady state)."""
        raise NotImplementedError

    def _attach_phase_profile(self, info: dict, mass_rhs: torch.Tensor) -> None:
        """Attach measured per-phase timings to an info dict (and to every
        convergence-history row) when ``options["profile_phases"]``."""
        if not self.options.get("profile_phases", False):
            return
        phases = self.profile_phases(mass_rhs / self.cell_vol)
        info.setdefault("timings", {})["phases"] = phases
        for row in info.get("convergence_history", {}).get("timings", []):
            if isinstance(row, dict):
                row.update(phases)

    def pressure_solve(self, face_weights: tuple, rhs_cells, p0, active=None) -> torch.Tensor:
        """The pressure Schur solve; a batch of right-hand sides (leading
        axis) solves each on its own, ``active`` masking it."""
        with tracing.span("beckmann.pressure", rhs_cells.device):
            trans = self.transmissibilities(face_weights)
            if self._use_mg:
                return bk.tpfa_mg_pcg(
                    trans,
                    rhs_cells,
                    p0,
                    dim=self.dim,
                    tol=self.cg_tol,
                    maxiter=self._mg_maxiter,
                    levels=self._mg_levels,
                    active=active,
                )
            return bk.tpfa_cg(
                trans,
                rhs_cells,
                p0,
                dim=self.dim,
                tol=self.cg_tol,
                maxiter=self.cg_maxiter,
                active=active,
            )

    def residual_norms(self, fluxes, p, face_weights, mass_rhs) -> float:
        """Residual of the optimality system (rescaled flux eq + div eq)."""
        distance = max(self.l1_dissipation(fluxes), 1e-30)
        return float(self._residual(fluxes, p, face_weights, mass_rhs, distance))

    # ------------------------------------------------------- the outer loop

    def _device_loop(self, step, state, distance, res_norm, history=None):
        """The JAX package's whole-solve device loop (``_build_fused_outer``)
        for one problem, or for a batch of problems along a leading axis as
        ``jax.vmap`` runs it (``batched_wasserstein``).

        ``step(state, k, running) -> (state, metrics)`` with the metrics
        ``[distance, increment^2, norm^2, residual, gap]``, ``(5,)`` or
        ``(B, 5)``; ``running`` is None for one problem, else a ``(B,)`` bool
        tensor of the problems still iterating.  The metrics are read once
        per iteration and judged in the solve's dtype; per problem: a
        non-finite iterate keeps the previous state and distance (status 2),
        convergence counts from the third iteration (status 1), the
        iteration cap leaves status 0; a problem that has stopped keeps its
        state.  ``res_norm`` > 0 normalizes the residual criterion, else each
        problem's first residual does.  ``history`` (one problem) records
        every iteration, with its host seconds.  Each iteration runs in the
        span ``beckmann.newton``.

        Returns ``(state, distances, statuses, steps)``, the last three
        ``(B,)`` numpy arrays (``B = 1`` for one problem).
        """
        cc = self.convergence_criteria
        real = np.float64 if self.dtype == torch.float64 else np.float32
        f32_max = float(np.finfo(np.float32).max)
        tol_inc = real(min(cc.tol_increment, f32_max))
        tol_dist = real(min(cc.tol_distance, f32_max))
        tol_res = real(min(cc.tol_residual, f32_max))
        tiny = real(1e-30)
        dist = np.atleast_1d(np.asarray(distance, dtype=real))
        single = np.ndim(distance) == 0
        res0 = np.full(dist.shape, res_norm, dtype=real)
        status = np.zeros(dist.shape, np.int32)
        steps = np.zeros(dist.shape, np.int64)
        device = _device_of(state)
        for k in range(int(cc.num_iter)):
            running = status == 0
            if not running.any():
                break
            if history is not None:
                tic = time.perf_counter()
            with tracing.span("beckmann.newton", device, iteration=k):
                mask = None if single else torch.from_numpy(running).to(device)
                new_state, metrics = step(state, k, mask)
                m = metrics.cpu().numpy().astype(real).reshape(-1, 5)
            steps[running] = k + 1
            d_k = m[:, 0]
            flux_inc = np.sqrt(m[:, 1])
            rel_inc = flux_inc / np.maximum(np.sqrt(m[:, 2]), tiny)
            residual = m[:, 3]
            dist_inc = np.abs(d_k - dist)
            rel_dist = dist_inc / np.maximum(d_k, tiny)
            if k == 0:
                res0 = np.where(res0 <= 0, residual, res0)
            rel_res = residual / np.maximum(res0, tiny)
            if history is not None:
                seconds = time.perf_counter() - tic
                history.append(
                    distance=float(d_k[0]),
                    distance_increment=float(dist_inc[0]),
                    residual=float(residual[0]),
                    increment=float(flux_inc[0]),
                    duality_gap=float(m[0, 4]),
                    timings={"total": seconds},
                    total_run_time=seconds,
                )
            finite = np.isfinite(d_k) & np.isfinite(rel_inc) & np.isfinite(rel_res)
            converged = (rel_inc < tol_inc) & (rel_dist < tol_dist) & (rel_res < tol_res) & (k > 1)
            accept = running & finite
            status[running & ~finite] = 2
            status[accept & converged] = 1
            if accept.all():
                state = new_state
            elif accept.any():
                keep = torch.from_numpy(accept).to(device)
                state = _select(keep, new_state, state)
            dist = np.where(accept, d_k, dist)
        return state, dist, status, steps

    def _iterate(
        self,
        step,
        state: tuple,
        distance: float,
        res_norm: float,
        device_path: bool,
        restore_on_divergence: bool = True,
        callbacks=None,
        report=None,
    ):
        """Run ``step(state, iteration) -> (state, metrics[5])`` to the
        stopping rule; the metrics are read once per iteration.

        ``device_path``: the JAX package's whole-solve device loop (criteria
        in the solve's dtype, convergence from the third iteration, a
        non-finite iterate keeps the previous state and stops).  Otherwise
        its host loop (float64 criteria; a non-finite iterate stops and
        restores only with ``restore_on_divergence``; then ``callbacks`` and
        ``report`` (the verbose line) run every iteration).  ``res_norm`` > 0
        normalizes the residual criterion, else the first residual does.

        Returns ``(state, distance, status, iterations, history, seconds)``.
        """
        cc = self.convergence_criteria
        history = BeckmannConvergenceHistory()
        status = ConvergenceStatus.IN_PROGRESS
        start = time.perf_counter()
        if device_path:
            state, dist, codes, steps = self._device_loop(
                lambda state, k, running: step(state, k), state, distance, res_norm, history
            )
            status = (
                ConvergenceStatus.NOT_CONVERGED,
                ConvergenceStatus.CONVERGED,
                ConvergenceStatus.DIVERGED,
            )[int(codes[0])]
            return state, float(dist[0]), status, max(int(steps[0]) - 1, 0), history, (
                time.perf_counter() - start
            )

        it = 0
        for it in range(int(cc.num_iter)):
            tic = time.perf_counter()
            old_state, old_distance = state, distance
            state, metrics = step(state, it)
            distance, inc_sq, norm_sq, residual, gap = metrics.tolist()
            flux_increment = float(np.sqrt(inc_sq))
            rel_inc = flux_increment / max(np.sqrt(norm_sq), 1e-30)
            distance_inc = abs(distance - old_distance)
            rel_dist = distance_inc / max(distance, 1e-30)
            history.append(
                distance=distance,
                distance_increment=distance_inc,
                residual=residual,
                increment=flux_increment,
                duality_gap=gap,
                timings={"total": time.perf_counter() - tic},
                total_run_time=time.perf_counter() - tic,
            )
            norm = res_norm if res_norm > 0 else history.residual[0]
            rel_res = residual / max(norm, 1e-30)
            if report is not None:
                report(it, distance, rel_dist, rel_inc, rel_res)
            status = cc.check_convergence_status(
                iter=it, increment=rel_inc, distance_increment=rel_dist, residual=rel_res
            )
            if restore_on_divergence and status == ConvergenceStatus.DIVERGED:
                # The full pre-divergence state, so the returned pressure
                # stays consistent with the returned fluxes.
                state, distance = old_state, old_distance
                break
            if it > 1 and status in (
                ConvergenceStatus.CONVERGED,
                ConvergenceStatus.NOT_CONVERGED,
            ):
                break
            if callbacks is not None:
                for callback in callbacks:
                    callback(self)
        return state, distance, status, it, history, time.perf_counter() - start

    def _info(self, distance, fluxes, status, iterations, history, seconds, device_path):
        unweighted = self.transport_density(fluxes, weighted=False)
        if device_path:
            # Nothing is compiled: the JAX package's trace+compile "setup"
            # is 0 here.
            timings = {
                "setup": 0.0,
                "assemble": 0.0,
                "acceleration": 0.0,
                "solve": seconds,
                "total": seconds,
            }
        else:
            timings = {"total": sum(h["total"] for h in history.timings)}
        return {
            "distance": distance,
            "flux_l1_norm": float(self.cell_vol * torch.sum(unweighted)),
            "converged": status == ConvergenceStatus.CONVERGED,
            "number_iterations": iterations,
            "convergence_history": history.as_dict(),
            "timings": timings,
            "peak_memory_consumption": peak_device_memory_gb(fluxes[0].device),
        }

    def _gap(self, distance: torch.Tensor, p: torch.Tensor, mass_rhs: torch.Tensor):
        dual = self._dual_value(p, mass_rhs)
        return (distance - dual) / torch.clamp(distance, min=1e-30)

    def _mass_diff(self, mass_diff) -> torch.Tensor:
        mass_diff = self._as_field(mass_diff)
        self.device = mass_diff.device
        return mass_diff

    # ----------------------------------------------------------- main call

    def _compatibility_check(self, img_1, img_2) -> None:
        assert tuple(img_1.num_voxels) == self.shape
        assert tuple(img_2.num_voxels) == self.shape

    def __call__(self, img_1, img_2):
        """W1 distance between two (equal-mass) scalar images, on their
        device."""
        assert img_1.scalar and img_2.scalar
        self._compatibility_check(img_1, img_2)
        mass_diff = img_2.img.to(self.dtype) - img_1.img.to(self.dtype)
        with tracing.span("beckmann.solve", mass_diff.device, pairs=1):
            distance, fluxes, pressure, info = self.solve_beckmann_problem(mass_diff)

        return_info = self.options.get("return_info", False)
        return_status = self.options.get("return_status", False)
        if return_info:
            c = self._constants(mass_diff.device)
            weight_arr = c.w_full
            flux_img = face_to_cell(self.grid, self.flat_flux(fluxes))
            info.update(
                {
                    "grid": self.grid,
                    "mass_diff": mass_diff,
                    "flux": flux_img,
                    "weight": weight_arr,
                    "weight_inv": 1.0 / weight_arr,
                    "weighted_flux": flux_img
                    if isinstance(c.w, float)
                    else flux_img * weight_arr[..., None],
                    "pressure": pressure,
                    "transport_density": self.transport_density(fluxes),
                    "src": img_1,
                    "dst": img_2,
                    # Final optimality certificate: the blur-swept certified
                    # relative gap; the per-iteration history entries use the
                    # raw certificate.
                    "duality_gap": self.duality_gap(fluxes, pressure, mass_diff),
                }
            )
            return distance, info
        if return_status:
            return distance, info["converged"]
        return distance

    def solve_beckmann_problem(self, mass_diff):
        raise NotImplementedError


class BeckmannNewtonSolver(BeckmannProblem):
    """Quasi-Newton (relaxed mobility fixed point) Beckmann solver."""

    def __init__(self, grid: Grid, weight=None, options: dict = {}) -> None:
        super().__init__(grid, weight, options)
        self.convergence_criteria = BeckmannConvergenceCriteria(
            num_iter=options.get("num_iter", 100),
            tol_increment=options.get("tol_increment", np.finfo(float).max),
            tol_distance=options.get("tol_distance", np.finfo(float).max),
            tol_residual=options.get("tol_residual", np.finfo(float).max),
        )

    def _traceable_mobility(self) -> bool:
        """Cell-based mobility: the modes the JAX package traces into its
        device loop (and the only ones its batched solve takes)."""
        return self.mobility_mode in _TRACEABLE_MOBILITY

    def compute_residual(self, fluxes, pressure, mass_rhs) -> torch.Tensor:
        """Flat (ndofs,) residual of the optimality system at the current
        iterate: flux block ``cell_vol*fw*u - grad p``, pressure block
        ``div u - mass_rhs``."""
        fw = self.compute_face_weights(fluxes)
        grad = bk.pressure_gradient_faces(pressure, self.face_vol, self.dim)
        flux_res = tuple(
            self.cell_vol * fw[d] * fluxes[d] - grad[d] for d in range(self.dim)
        )
        div_res = bk.face_divergence(fluxes, self.face_vol, self.dim) - mass_rhs
        return self.flat_view(flux_res, div_res)

    def compute_jacobian(self, fluxes):
        """Matrix-free Jacobian of the pressure Schur system at the current
        mobility linearization (a callable applying the weighted TPFA
        operator)."""
        trans = self.transmissibilities(self.compute_face_weights(fluxes))
        device = fluxes[0].device

        def apply(p):
            return bk.tpfa_apply(
                self._as_field(p, device).reshape(self.shape), trans, self.dim
            )

        return apply

    def profile_phases(self, mass_diff, reps: int = 5) -> dict:
        """Measured seconds per Newton phase: mobility -> pressure solve ->
        flux update -> metrics."""
        mass_diff = self._as_field(mass_diff)
        device = mass_diff.device
        mass_rhs = self.cell_vol * mass_diff
        c = self._constants(device)
        p0 = torch.zeros(self.shape, dtype=self.dtype, device=device)
        p = self.pressure_solve(c.base_face_weights, mass_rhs, p0)
        fluxes = self.flux_from_pressure(c.base_face_weights, p)
        fw = self._cell_based_face_weights(fluxes)

        def metrics(fl, pp, w, rhs):
            distance = self._l1(fl)
            return self._residual(fl, pp, w, rhs, torch.clamp(distance, min=1e-30))

        return {
            "mobility": self._time_phase(self._cell_based_face_weights, (fluxes,), reps),
            "pressure_solve": self._time_phase(
                lambda w, rhs: self.pressure_solve(w, rhs, p0), (fw, mass_rhs), reps
            ),
            "flux_update": self._time_phase(self.flux_from_pressure, (fw, p), reps),
            "metrics": self._time_phase(metrics, (fluxes, p, fw, mass_rhs), reps),
        }

    def _newton_step(self, state, it, mass_rhs, device_path, running=None):
        """One Newton iteration (the JAX package's ``_fused_step_fn`` and its
        Anderson variants): face weights, the pressure solve from zero, the
        fluxes, then the metrics ``[distance, increment^2, norm^2, residual,
        gap]``; each per problem (metrics ``(B, 5)``) for a batch along a
        leading axis, whose pressure solve ``running`` masks."""
        fluxes, p, aa = state
        face_weights = self.compute_face_weights(fluxes)
        # Solve from zero: warm-starting lets the weakly constrained
        # pressure in zero-flux regions drift unboundedly.
        p_new = self.pressure_solve(face_weights, mass_rhs, torch.zeros_like(p), running)
        fluxes_new = self.flux_from_pressure(face_weights, p_new)
        if aa is not None:
            gk = self._flatten_fluxes(fluxes_new)
            fk = gk - self._flatten_fluxes(fluxes)
            aa, mixed = anderson_mix(aa, gk, fk, restart=self.aa_restart)
            fluxes_new = self._unflatten_fluxes(mixed)
        elif self.anderson is not None and not device_path:
            flat = self.flat_flux(fluxes_new).cpu().numpy()
            flat_old = self.flat_flux(fluxes).cpu().numpy()
            accelerated = self.anderson(flat, flat - flat_old, it)
            fluxes_new = tuple(
                torch.from_numpy(a).to(device=p.device, dtype=self.dtype)
                for a in self.grid.face_arrays(accelerated)
            )
        distance = self._l1(fluxes_new)
        inc_sq = sum(self._cell_sum((fluxes_new[d] - fluxes[d]) ** 2) for d in range(self.dim))
        norm_sq = sum(self._cell_sum(fluxes_new[d] ** 2) for d in range(self.dim))
        residual = self._residual(
            fluxes_new, p_new, face_weights, mass_rhs, torch.clamp(distance, min=1e-30)
        )
        gap = self._gap(distance, p_new, mass_rhs)
        metrics = torch.stack([distance, inc_sq, norm_sq, residual, gap], dim=-1)
        return (fluxes_new, p_new, aa), metrics

    def solve_beckmann_problem(self, mass_diff):
        mass_diff = self._mass_diff(mass_diff)
        device = mass_diff.device
        mass_rhs = self.cell_vol * mass_diff
        c = self._constants(device)

        # Darcy initialization with unit (L_init-scaled) mobility.
        L_init = self.options.get("L_init", 1.0)
        face_weights = tuple(L_init * w for w in c.base_face_weights)
        p = torch.zeros(self.shape, dtype=self.dtype, device=device)
        p = self.pressure_solve(face_weights, mass_rhs, p)
        fluxes = self.flux_from_pressure(face_weights, p)
        distance = self.l1_dissipation(fluxes)

        # The JAX package's device loop runs for cell-based mobility without
        # callbacks or printing, with the tensor Anderson mixing inside; its
        # host loop otherwise, with the numpy Anderson class.
        device_path = (
            self.mobility_mode in _TRACEABLE_MOBILITY
            and self.callbacks is None
            and not self.verbose
        )
        aa_state = None
        if device_path and self.aa_depth > 0:
            num_faces = sum(int(np.prod(s)) for s in self.grid.faces_shape)
            aa_state = anderson_init(num_faces, self.aa_depth, self.dtype, device)

        def step(state, it):
            return self._newton_step(state, it, mass_rhs, device_path)

        def report(it, distance, rel_dist, rel_inc, rel_res):
            if self.verbose:
                print(
                    f"Newton iter {it} | W1 {distance:.6e} | dW/W {rel_dist:.2e} | "
                    f"du/u {rel_inc:.2e} | res {rel_res:.2e}"
                )

        state, distance, status, iterations, history, seconds = self._iterate(
            step,
            (fluxes, p, aa_state),
            distance,
            0.0,
            device_path,
            callbacks=self.callbacks,
            report=report,
        )
        fluxes, p, _ = state
        info = self._info(distance, fluxes, status, iterations, history, seconds, device_path)
        self._attach_phase_profile(info, mass_rhs)
        return distance, fluxes, p, info


class BeckmannBregmanSolver(BeckmannProblem):
    """Split-Bregman Beckmann solver with optional adaptive reweighting.

    The u-step has constant transmissibilities (until a reweighting), so the
    same TPFA operator serves all iterations (warm-started CG).
    """

    def __init__(self, grid: Grid, weight=None, options: dict = {}) -> None:
        super().__init__(grid, weight, options)
        self.L = options.get("L", 1.0)
        self.bregman_update = options.get("bregman_update", None)
        self.convergence_criteria = BeckmannConvergenceCriteria(
            num_iter=options.get("num_iter", 100),
            tol_increment=options.get("tol_increment", np.finfo(float).max),
            tol_distance=options.get("tol_distance", np.finfo(float).max),
            tol_residual=options.get("tol_residual", np.finfo(float).max),
        )

    def _vector_shrink(self, fluxes: tuple, thresholds: tuple) -> tuple:
        """Isotropic shrink: scale normal fluxes by the vectorial magnitude
        (the reconstructed vector flux norm on each face, via the mobility
        machinery), preserving the RT0 direction."""
        face_weights = self.compute_face_weights(fluxes)
        out = []
        for k in range(self.dim):
            norm = 1.0 / face_weights[k]  # |vector flux| on faces
            scaling = torch.clamp(norm - thresholds[k], min=0.0) / (
                norm + self.regularization
            )
            out.append(scaling * fluxes[k])
        return tuple(out)

    def profile_phases(self, mass_diff, reps: int = 5) -> dict:
        """Measured seconds per Bregman phase: pressure solve (u-step) ->
        flux update -> shrinkage -> metrics."""
        mass_diff = self._as_field(mass_diff)
        device = mass_diff.device
        mass_rhs = self.cell_vol * mass_diff
        c = self._constants(device)
        scaled_weights = tuple(w / self.L for w in c.base_face_weights)
        thresholds = tuple(self.L / w for w in c.base_face_weights)
        p = torch.zeros(self.shape, dtype=self.dtype, device=device)
        p = self.pressure_solve(scaled_weights, mass_rhs, p)
        fluxes = self.flux_from_pressure(scaled_weights, p)

        def metrics(fl, rhs):
            distance = self._l1(fl)
            div = bk.face_divergence(fl, self.face_vol, self.dim)
            return distance, torch.linalg.vector_norm(div - rhs)

        return {
            "pressure_solve": self._time_phase(
                lambda rhs, pp: self.pressure_solve(scaled_weights, rhs, pp),
                (mass_rhs, p),
                reps,
            ),
            "flux_update": self._time_phase(
                self.flux_from_pressure, (scaled_weights, p), reps
            ),
            "shrinkage": self._time_phase(
                lambda fl: self._vector_shrink(fl, thresholds), (fluxes,), reps
            ),
            "metrics": self._time_phase(metrics, (fluxes, mass_rhs), reps),
        }

    def solve_beckmann_problem(self, mass_diff):
        mass_diff = self._mass_diff(mass_diff)
        device = mass_diff.device
        mass_rhs = self.cell_vol * mass_diff
        c = self._constants(device)

        face_weights = tuple(c.base_face_weights)
        # Effective mobility weight (1/L) * w_f.
        scaled_weights = tuple(w / self.L for w in face_weights)

        # Darcy initialization (unit mobility), as in the reference.
        p = torch.zeros(self.shape, dtype=self.dtype, device=device)
        p = self.pressure_solve(scaled_weights, mass_rhs, p)
        fluxes = self.flux_from_pressure(scaled_weights, p)
        thresholds = tuple(self.L / w for w in face_weights)
        d_aux = self._vector_shrink(fluxes, thresholds)
        b_aux = tuple(fluxes[k] - d_aux[k] for k in range(self.dim))
        distance = self.l1_dissipation(fluxes)
        res_norm = float(torch.linalg.vector_norm(mass_rhs))

        # The JAX package's device loop runs while the weights stay constant
        # (no adaptive reweighting) and the mobility is cell-based, without
        # callbacks or printing; Anderson then mixes inside it, AFTER the
        # metrics.  Its host loop mixes with the numpy class BEFORE them.
        device_path = (
            self.bregman_update is None
            and self.mobility_mode in _TRACEABLE_MOBILITY
            and self.callbacks is None
            and not self.verbose
        )
        aa_state = None
        if device_path and self.aa_depth > 0:
            num_faces = sum(int(np.prod(s)) for s in self.grid.faces_shape)
            aa_state = anderson_init(2 * num_faces, self.aa_depth, self.dtype, device)

        def step(state, it):
            _, p, d_aux, b_aux, scaled_weights, thresholds, aa = state
            # u-step: (1/L) W M u - D^T p = (1/L) W M (d - b); D u = rhs.
            db = tuple(d_aux[k] - b_aux[k] for k in range(self.dim))
            div_db = bk.face_divergence(db, self.face_vol, self.dim)
            p_new = self.pressure_solve(scaled_weights, mass_rhs - div_db, p)
            correction = self.flux_from_pressure(scaled_weights, p_new)
            fluxes = tuple(db[k] + correction[k] for k in range(self.dim))
            # Vectorial shrinkage of u + b.
            dub = tuple(fluxes[k] + b_aux[k] for k in range(self.dim))
            d_new = self._vector_shrink(dub, thresholds)
            b_new = tuple(dub[k] - d_new[k] for k in range(self.dim))

            if self.anderson is not None and not device_path:
                gk = torch.cat([self._flatten_fluxes(d_new), self._flatten_fluxes(b_new)])
                xk = torch.cat([self._flatten_fluxes(d_aux), self._flatten_fluxes(b_aux)])
                gk, xk = gk.cpu().numpy(), xk.cpu().numpy()
                mixed = torch.from_numpy(self.anderson(gk, gk - xk, it)).to(
                    device=device, dtype=self.dtype
                )
                half = mixed.shape[0] // 2
                d_new = self._unflatten_fluxes(mixed[:half])
                b_new = self._unflatten_fluxes(mixed[half:])

            # Optional adaptive reweighting (thresholds 1/w, not L/w, as the
            # JAX package's host loop sets them).
            if self.bregman_update is not None and self.bregman_update(it):
                face_weights = self.compute_face_weights(fluxes)
                scaled_weights = tuple(w / self.L for w in face_weights)
                thresholds = tuple(1.0 / w for w in face_weights)

            distance = self._l1(fluxes)
            # Bregman metrics (reference): aux/force increment vs flux norm,
            # and the mass-conservation residual vs the mass norm.
            inc_sq = sum(
                torch.sum((d_new[k] - d_aux[k]) ** 2) + torch.sum((b_new[k] - b_aux[k]) ** 2)
                for k in range(self.dim)
            )
            norm_sq = sum(torch.sum(fluxes[k] ** 2) for k in range(self.dim))
            div = bk.face_divergence(fluxes, self.face_vol, self.dim)
            residual = torch.linalg.vector_norm(div - mass_rhs)
            # _dual_value rescales onto the feasibility boundary, so the
            # Bregman-scaled pressure still yields a valid bound.
            gap = self._gap(distance, p_new, mass_rhs)
            metrics = torch.stack([distance, inc_sq, norm_sq, residual, gap])

            if aa is not None:
                gk = torch.cat([self._flatten_fluxes(d_new), self._flatten_fluxes(b_new)])
                xk = torch.cat([self._flatten_fluxes(d_aux), self._flatten_fluxes(b_aux)])
                aa, mixed = anderson_mix(aa, gk, gk - xk, restart=self.aa_restart)
                half = mixed.shape[0] // 2
                d_new = self._unflatten_fluxes(mixed[:half])
                b_new = self._unflatten_fluxes(mixed[half:])
            state = (fluxes, p_new, d_new, b_new, scaled_weights, thresholds, aa)
            return state, metrics

        def report(it, distance, rel_dist, rel_inc, rel_res):
            if self.verbose:
                print(f"Bregman iter {it} | W1 {distance:.6e} | dW/W {rel_dist:.2e}")

        state, distance, status, iterations, history, seconds = self._iterate(
            step,
            (fluxes, p, d_aux, b_aux, scaled_weights, thresholds, aa_state),
            distance,
            max(res_norm, 1e-30),
            device_path,
            restore_on_divergence=device_path,
            callbacks=self.callbacks,
            report=report,
        )
        fluxes, p = state[0], state[1]
        info = self._info(distance, fluxes, status, iterations, history, seconds, device_path)
        self._attach_phase_profile(info, mass_rhs)
        return distance, fluxes, p, info


class ProjectedPoissonSolver:
    """Matrix-free projected-CG/MG Poisson solver on the TPFA stencil.

    What :meth:`BeckmannGproxPGHDSolver.setup_poisson_solver` returns (the
    reference assembles a sparse Laplacian for KSP/pyamg; here the operator
    stays a stencil closure).  ``solve`` projects the rhs onto the mean-zero
    compatibility space before solving.
    """

    def __init__(
        self,
        problem: "BeckmannProblem",
        face_weights: tuple,
        rtol: float,
        amg_options: Optional[dict] = None,
    ) -> None:
        self._problem = problem
        self._trans = problem.transmissibilities(face_weights)
        self._rtol = float(rtol)
        self._amg = amg_options or {}

    def solve(self, rhs, x0=None) -> torch.Tensor:
        problem = self._problem
        device = self._trans[0].device
        rhs = problem._as_field(rhs, device).reshape(problem.shape)
        rhs = rhs - torch.mean(rhs)
        if x0 is None:
            x0 = torch.zeros(problem.shape, dtype=problem.dtype, device=device)
        else:
            x0 = problem._as_field(x0, device).reshape(problem.shape)
        if problem._use_mg:
            return bk.tpfa_mg_pcg(
                self._trans,
                rhs,
                x0,
                dim=problem.dim,
                tol=self._rtol,
                maxiter=problem._mg_maxiter,
                levels=int(self._amg.get("levels", problem._mg_levels)),
                nu=int(self._amg.get("presmoother_iterations", 2)),
                nu_coarse=int(self._amg.get("coarse_iterations", 40)),
            )
        return bk.tpfa_cg(
            self._trans, rhs, x0, dim=problem.dim, tol=self._rtol, maxiter=problem.cg_maxiter
        )

    def kill(self) -> None:
        """Parity no-op: the reference's KSP holds PETSc state that must be
        freed; the stencil closure owns no external resources."""


class BeckmannGproxPGHDSolver(BeckmannProblem):
    """Primal-dual (PDHG) Beckmann solver with G-prox Poisson
    preconditioning: the dual update is preconditioned by the inverse
    Laplacian (Leray-type projection); the Poisson sub-solves use the
    projected CG/MG of the other solvers."""

    def __init__(self, grid: Grid, weight=None, options: dict = {}) -> None:
        super().__init__(grid, weight, options)
        self.convergence_criteria = BeckmannConvergenceCriteria(
            num_iter=options.get("num_iter", 300),
            tol_increment=options.get("tol_increment", np.finfo(float).max),
            tol_distance=options.get("tol_distance", np.finfo(float).max),
            tol_residual=options.get("tol_residual", np.finfo(float).max),
        )
        self.tau = options.get("tau", 1.0)
        self.sigma = options.get("sigma", 1.0)
        self.setup_amg_options()

    def setup_amg_options(self) -> None:
        """Multilevel-solver knobs: level count and smoothing sweeps, from
        ``options['amg_options']`` (keys ``levels``,
        ``presmoother_iterations``, ``coarse_iterations``)."""
        user = self.options.get("amg_options", {})
        self.amg_options = {
            "levels": int(user.get("levels", self._mg_levels)),
            "presmoother_iterations": int(user.get("presmoother_iterations", 2)),
            "coarse_iterations": int(user.get("coarse_iterations", 40)),
        }

    def setup_poisson_solver(
        self,
        solver_prefix: str = "",
        rtol: float = 1e-6,
        permeability_faces=None,
    ) -> ProjectedPoissonSolver:
        """Poisson solver with optional per-face permeability kappa (per-axis
        arrays or a flat face vector; the TPFA face weights are 1/kappa);
        ``None`` gives the unweighted Laplacian on the last solve's device
        (the CUDA card before any solve)."""
        if permeability_faces is None:
            device = self.device if self.device is not None else "cuda"
            face_weights = tuple(self._constants(device).base_face_weights)
        else:
            if not isinstance(permeability_faces, (tuple, list)):
                permeability_faces = self.grid.face_arrays(as_tensor(permeability_faces))
            face_weights = tuple(
                1.0 / torch.clamp(as_tensor(k).to(self.dtype), min=self.regularization)
                for k in permeability_faces
            )
        return ProjectedPoissonSolver(self, face_weights, rtol, self.amg_options)

    def compute_kantorovich_potential(self, mass_diff, fluxes, tol: float = 1e-6):
        """Kantorovich potential from the flux: a Poisson solve weighted by
        the face transport density |u| (the full reconstructed face flux)."""
        solver = self.setup_poisson_solver(
            "transport_density_weighted_poisson",
            rtol=tol,
            permeability_faces=tuple(self._face_flux_norms(fluxes)),
        )
        rhs = self.cell_vol * self._as_field(mass_diff, fluxes[0].device)
        x0 = getattr(self, "kantorovich_potential", None)
        potential = solver.solve(rhs, x0=x0)
        self.kantorovich_potential = potential
        solver.kill()
        return potential

    def compute_dual(self, phi, mass_diff) -> float:
        """Dual objective int phi d(f+ - f-)."""
        phi = self._as_field(phi)
        return float(self.cell_vol * torch.sum(phi * self._as_field(mass_diff, phi.device)))

    def compute_primal(self, fluxes) -> float:
        """Primal objective int |u|."""
        return self.l1_dissipation(fluxes)

    def leray_projection(self, fluxes: tuple) -> tuple:
        """Project a face flux field onto divergence-free fields:
        ``u - grad(Laplace^-1 div u)``."""
        device = fluxes[0].device
        div = bk.face_divergence(fluxes, self.face_vol, self.dim)
        unit = tuple(self._constants(device).base_face_weights)
        potential = self.pressure_solve(
            unit,
            div - torch.mean(div),
            torch.zeros(self.shape, dtype=self.dtype, device=device),
        )
        correction = self.flux_from_pressure(unit, potential)
        return tuple(fluxes[d] - correction[d] for d in range(self.dim))

    def solve_beckmann_problem(self, mass_diff):
        mass_diff = self._mass_diff(mass_diff)
        device = mass_diff.device
        mass_rhs = self.cell_vol * mass_diff
        unit_weights = tuple(self._constants(device).base_face_weights)

        fluxes = self.zero_fluxes(device)
        phi = torch.zeros(self.shape, dtype=self.dtype, device=device)  # dual potential

        def step(state, it):
            fluxes, fluxes_bar, phi = state
            div_residual = bk.face_divergence(fluxes_bar, self.face_vol, self.dim) - mass_rhs
            poisson_update = self.pressure_solve(
                unit_weights, div_residual, torch.zeros_like(phi)
            )
            phi_new = phi + self.sigma * poisson_update

            # Primal descent + vectorial shrinkage (prox of the isotropic L1
            # of the RT0-reconstructed flux, as in Bregman).
            grad = bk.pressure_gradient_faces(phi_new, self.face_vol, self.dim)
            v = tuple(fluxes[k] - self.tau * grad[k] / self.cell_vol for k in range(self.dim))
            v_weights = self._cell_based_face_weights(v)
            new_fluxes = []
            for k in range(self.dim):
                norm = 1.0 / v_weights[k]
                threshold = self.tau * unit_weights[k]
                scaling = torch.clamp(norm - threshold, min=0.0) / (norm + self.regularization)
                new_fluxes.append(scaling * v[k])
            new_fluxes = tuple(new_fluxes)
            bar = tuple(2.0 * new_fluxes[k] - fluxes[k] for k in range(self.dim))
            distance = self._l1(new_fluxes)
            inc_sq = sum(torch.sum((new_fluxes[k] - fluxes[k]) ** 2) for k in range(self.dim))
            norm_sq = sum(torch.sum(new_fluxes[k] ** 2) for k in range(self.dim))
            div_res = torch.linalg.vector_norm(
                bk.face_divergence(new_fluxes, self.face_vol, self.dim) - mass_rhs
            )
            gap = self._gap(distance, phi_new, mass_rhs)
            metrics = torch.stack([distance, inc_sq, norm_sq, div_res, gap])
            return (new_fluxes, bar, phi_new), metrics

        # The JAX package's device loop for cell-based mobility without
        # callbacks or printing; its host loop (no divergence handling, no
        # callbacks) otherwise.
        device_path = (
            self.mobility_mode in _TRACEABLE_MOBILITY
            and self.callbacks is None
            and not self.verbose
        )
        state, distance, status, iterations, history, seconds = self._iterate(
            step,
            (fluxes, fluxes, phi),
            0.0,
            0.0,
            device_path,
            restore_on_divergence=device_path,
        )
        fluxes, _, phi = state
        info = self._info(distance, fluxes, status, iterations, history, seconds, device_path)
        # Kantorovich potential = phi (up to scaling).
        return distance, fluxes, phi, info
