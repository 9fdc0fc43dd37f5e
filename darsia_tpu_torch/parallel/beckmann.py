"""Spatially sharded Beckmann Newton solve (domain-decomposed W1).

Counterpart of :mod:`darsia_tpu.parallel.beckmann`.  One problem's leading
axis is split over the ``space`` mesh axis (2-D and 3-D).  The whole Newton
iteration (cell transport density, harmonic mobility averaging, the
nullspace-projected PCG pressure solve, the flux update, optional Anderson
mixing and the convergence metrics) runs shard by shard: stencils touch one
halo slab (:func:`~darsia_tpu_torch.parallel.collectives.shift`), scalars are
``psum``/``pmax`` reductions, and the host reads one flag per CG iteration
and one per Newton iteration.

The math is the single-device
:class:`~darsia_tpu_torch.measure.beckmann.BeckmannNewtonSolver`'s with
``mobility_mode=cell_based`` and ``l1_mode=constant_cell_projection``.

Shard-local layout (leading axis split, ``R = shape[0] / num`` slabs):

- ``u0_p``: (R, *rest) axis-0 flux on the face ABOVE each local slab;
  shard 0's slab 0 is the absent global boundary face, pinned to 0;
- ``u_rest[k]``: local interior faces along axis ``k+1``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..measure import beckmann_kernels as bk
from .collectives import all_gather, pmax, psum, shift
from .halo import halo_exchange
from .mesh import Mesh, Placement
from .tpfa import _by_device, _masked, _mul, projected_pcg_local

__all__ = ["sharded_beckmann_newton"]


def _face_pairs(x: torch.Tensor, axis: int) -> tuple:
    n = x.shape[axis]
    return x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)


def _rest_stencil(x: torch.Tensor, trans_rest: tuple) -> torch.Tensor:
    """The TPFA operator along axes 1.. of one block (axis 0 left out):
    the face flux t * (x_j - x_{j+1}) enters cell j and leaves cell j + 1."""
    out = None
    for k, t in enumerate(trans_rest):
        lo, hi = _face_pairs(x, k + 1)
        flux = t * (lo - hi)
        term = bk._pad_axis(flux, k + 1, 0, 1) - bk._pad_axis(flux, k + 1, 1, 0)
        out = term if out is None else out + term
    return out


def _anderson_mix_sharded(state: list, gk: list, fk: list, iteration: int, reg: float = 1e-5) -> list:
    """One Anderson(depth) type-II mixing step with sharded history.

    ``state[i]`` holds shard ``i``'s LOCAL flat flux history (``F``, ``G``,
    ``fkm1``, ``gkm1``), updated in place; the depth x depth normal
    equations are assembled with one ``psum``, so every shard solves the
    same small ridge system.  Returns the mixed iterate per shard.
    """
    if iteration == 0:
        for s, g, f in zip(state, gk, fk):
            s["fkm1"], s["gkm1"] = f, g
        return list(gk)
    depth = state[0]["F"].shape[0]
    col = (iteration - 1) % depth
    parts = []
    for s, g, f in zip(state, gk, fk):
        s["F"][col] = f - s["fkm1"]
        s["G"][col] = g - s["gkm1"]
        s["fkm1"], s["gkm1"] = f, g
        F = s["F"]
        parts.append(torch.cat([F @ F.T, (F @ f)[:, None]], dim=1))
    systems = psum(parts)
    gammas = {}
    mixed = []
    for s, g, system in zip(state, gk, systems):
        if id(system) not in gammas:
            gram, rhs = system[:, :depth], system[:, depth:]
            lam = reg * torch.sqrt(torch.clamp(torch.diagonal(gram).max(), min=1e-30))
            eye = torch.eye(depth, dtype=gram.dtype, device=gram.device)
            gammas[id(system)] = torch.linalg.solve_ex(gram + (lam**2 + 1e-30) * eye, rhs)[0]
        mixed.append(g - (s["G"].T @ gammas[id(system)])[:, 0])
    return mixed


def sharded_beckmann_newton(
    mesh: Mesh,
    shape: tuple,
    voxel_size=1.0,
    axis: str = "space",
    num_iter: int = 100,
    tol_increment: float = 1e-4,
    tol_distance: float = 1e-4,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 500,
    regularization: Optional[float] = None,
    aa_depth: int = 0,
    weight=None,
    precond: str = "jacobi",
):
    """Build a sharded W1 solve ``solve(mass_diff) -> (distance, p, k)``.

    ``mass_diff`` is the signed mass difference on ``shape`` (2-D or 3-D;
    destination minus source by the facade's convention, normalized to equal
    total mass); ``distance`` is the W1 value (a 0-d tensor), ``p`` the
    pressure and ``k`` the Newton iteration count, both on the mesh's first
    device.  ``shape[0]`` must divide by the mesh axis size (other mesh axes
    of size 1).  ``weight`` is an optional cell weight field (heterogeneous
    metric, split with the leading axis).  ``aa_depth > 0`` enables Anderson
    mixing of the flux iterate (sharded history, psum-assembled normal
    equations).

    ``precond="two_level"`` adds a coarse-grid correction to the inner CG's
    Jacobi preconditioner: the transmissibilities are Galerkin-coarsened on
    each shard (2x per level, aggregates never straddle shards), the small
    coarse problem is all-gathered and a geometric-MG V-cycle runs on it on
    every device.  Where no local coarsening fits it warns and uses Jacobi.

    ``solve(mass_diff, return_fluxes=True)`` returns ``(distance, fluxes, p,
    k)`` with the per-axis face arrays in the single-device layout.
    """
    shape = tuple(int(s) for s in shape)
    dim = len(shape)
    if dim not in (2, 3):
        raise ValueError("sharded_beckmann_newton supports 2-D and 3-D.")
    num = len(mesh.line(axis))
    if shape[0] % num:
        raise ValueError("Leading axis must divide the mesh axis.")
    local0 = shape[0] // num
    rest = shape[1:]
    local_shape = (local0,) + rest

    voxel = (
        np.full(dim, float(voxel_size))
        if np.isscalar(voxel_size)
        else np.asarray(voxel_size, dtype=float)
    )
    if voxel.shape != (dim,):
        raise ValueError(f"voxel size {voxel_size} for a {dim}-D grid")
    cell_vol = float(np.prod(voxel))
    face_vol = [float(np.prod(np.delete(voxel, d))) for d in range(dim)]
    reg = float(regularization) if regularization is not None else float(np.finfo(np.float32).eps)

    if precond not in ("jacobi", "two_level"):
        raise ValueError(f"Unknown precond {precond!r}; use 'jacobi' or 'two_level'.")
    # Two-level preconditioner: number of LOCAL 2x coarsening levels
    # (aggregates must not straddle shards; interior axes stay >= 8).
    local_levels = 0
    if precond == "two_level":
        l0, rest_min = local0, min(rest)
        while local_levels < 3 and l0 % 2 == 0 and l0 >= 2 and rest_min % 2 == 0 and rest_min >= 16:
            l0 //= 2
            rest_min //= 2
            local_levels += 1
        if local_levels == 0:
            warnings.warn(
                "precond='two_level' admits no local coarsening for shape "
                f"{shape} over {num} shards (leading local extent {local0}, "
                f"min interior extent {min(rest)}); falling back to Jacobi. "
                "Tighten cg_maxiter with care.",
                stacklevel=2,
            )
    use_coarse = local_levels > 0

    rest_faces_shapes = [
        (local0,) + tuple(n - 1 if k == j else n for j, n in enumerate(rest)) for k in range(dim - 1)
    ]
    sizes = [int(np.prod(local_shape))] + [int(np.prod(s)) for s in rest_faces_shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    placement = Placement(mesh, (axis,) + (None,) * (dim - 1))

    # Operands placed once: the weight field split by slabs, and the masks
    # of the padded global top face (shard 0) and of the global bottom slab
    # (the last shard); None on the other shards.
    if weight is None:
        cell_weight = placement.split_line(torch.ones(shape, dtype=torch.float32))
    else:
        data = weight.img if hasattr(weight, "img") else weight
        if tuple(data.shape) != shape:
            raise ValueError(f"weight of shape {tuple(data.shape)}, grid {shape}")
        cell_weight = [w.to(torch.float32) for w in placement.split_line(data)]
    cw_sq = [w**2 for w in cell_weight]
    pad_face, last_global = [None] * num, [None] * num
    for i, w in enumerate(cell_weight):
        slabs = torch.arange(local0, device=w.device).reshape((-1,) + (1,) * (dim - 1))
        if i == 0:
            pad_face[i] = (slabs == 0).expand(local_shape)
        if i == num - 1:
            last_global[i] = (slabs == local0 - 1).expand(local_shape)

    def face_below(u0_p):
        """Axis-0 flux on the face BELOW each local slab (the next slab's
        'above' face; zero on the global bottom boundary)."""
        nxt = shift([u[:1] for u in u0_p], -1)
        return [
            _masked(torch.cat([u[1:], n], dim=0), lg, 0.0)
            for u, n, lg in zip(u0_p, nxt, last_global)
        ]

    def transport_density(u0_p, u_rest):
        """|weight * RT0 flux| at the cell centres (constant cell
        projection)."""
        out = []
        for u0, below, ur, pf, w in zip(u0_p, face_below(u0_p), u_rest, pad_face, cell_weight):
            comp_sq = (0.5 * (_masked(u0, pf, 0.0) + below)) ** 2
            for k, u in enumerate(ur):
                ax = k + 1
                comp = 0.5 * (bk._pad_axis(u, ax, 1, 0) + bk._pad_axis(u, ax, 0, 1))
                comp_sq = comp_sq + comp**2
            out.append(w * torch.sqrt(comp_sq))
        return out

    def face_weights(rho):
        """1 / harmonic face average of rho / cw^2 (cell-based mobility)."""
        maxima = pmax([r.max() for r in rho])
        cell_inv = [
            torch.maximum(r, torch.clamp(1e-6 * m, min=reg)) / c
            for r, m, c in zip(rho, maxima, cw_sq)
        ]
        fw_rest = []
        for ci in cell_inv:
            per_axis = []
            for k in range(dim - 1):
                a, b = _face_pairs(ci, k + 1)
                inv = 2.0 * a * b / torch.clamp(a + b, min=1e-30)
                per_axis.append(1.0 / torch.clamp(inv, min=1e-30))
            fw_rest.append(tuple(per_axis))
        # Axis-0 faces (above each local slab): the previous shard's last
        # cell slab pairs with this shard's first; on shard 0 that is the
        # ring's wrap from the last shard, masked by the pad face.
        prev_last = shift([ci[-1:] for ci in cell_inv], 1)
        fw0_p = []
        for ci, pl, pf in zip(cell_inv, prev_last, pad_face):
            above = torch.cat([pl, ci[:-1]], dim=0)
            inv0 = 2.0 * above * ci / torch.clamp(above + ci, min=1e-30)
            fw0_p.append(_masked(1.0 / torch.clamp(inv0, min=1e-30), pf, 1.0))
        return fw0_p, fw_rest

    def coarsen_local(t0, trans_rest):
        """One local 2x Galerkin coarsening in the padded layout: coarse
        axis-0 faces at even padded slots (the pad stays the pad); the
        interior-axis faces as :func:`beckmann_kernels.tpfa_coarsen_trans`
        coarsens them."""
        t0 = t0[::2]
        for e in range(1, dim):
            t0 = bk._pair_sum(t0, e)
        rest_c = []
        for k in range(dim - 1):
            ax = k + 1
            t = bk._slice_axis(trans_rest[k], ax, 1, None, 2)
            for e in range(dim):
                if e != ax:
                    t = bk._pair_sum(t, e)
            rest_c.append(t)
        return t0, tuple(rest_c)

    def coarse_preconditioner(trans0_p, trans_rest, diag):
        """Additive Jacobi + gathered coarse V-cycle correction."""
        coarse = [(t0, tr) for t0, tr in zip(trans0_p, trans_rest)]
        for _ in range(local_levels):
            coarse = [coarsen_local(t0, tr) for t0, tr in coarse]
        local0_c = coarse[0][0].shape[0]
        # The global coarse faces: the concatenated padded slots minus
        # shard 0's pad slot are all interior faces.
        t0_g = all_gather([t0 for t0, _ in coarse])
        rest_g = [all_gather([tr[k] for _, tr in coarse]) for k in range(dim - 1)]
        coarse_shape = (local0_c * num,) + tuple(n // 2**local_levels for n in rest)
        levels = bk.tpfa_mg_levels(coarse_shape)
        # One hierarchy per distinct gathered copy (per device).
        hierarchies = {}
        for i, t in enumerate(t0_g):
            if id(t) not in hierarchies:
                trans = (t[1:],) + tuple(rg[i] for rg in rest_g)
                hierarchies[id(t)] = bk.tpfa_mg_hierarchy(trans, dim, levels)
        hierarchy = [hierarchies[id(t)] for t in t0_g]
        shapes = [local_shape]
        for _ in range(local_levels - 1):
            shapes.append(tuple((n + 1) // 2 for n in shapes[-1]))

        def M(r):
            rc = []
            for x in r:
                for _ in range(local_levels):
                    x = bk._restrict_cells(x, dim)
                rc.append(x)
            rc_g = all_gather(rc)
            cycles = {}
            out = []
            for i, (x, g, h, d) in enumerate(zip(r, rc_g, hierarchy, diag)):
                if id(g) not in cycles:
                    cycles[id(g)] = bk._tpfa_vcycle(g, h, dim, 2, 40)
                ec = cycles[id(g)].narrow(0, i * local0_c, local0_c)
                for fine_shape in reversed(shapes):
                    ec = bk._prolong_cells(ec, fine_shape, dim)
                out.append(x / d + ec)
            return out

        return M

    def tpfa_operator(fw0_p, fw_rest):
        """(A, diag, M) of the shard-local weighted TPFA blocks."""
        trans0_p = [
            _masked(face_vol[0] ** 2 / (fw0 * cell_vol), pf, 0.0) for fw0, pf in zip(fw0_p, pad_face)
        ]
        trans_rest = [
            tuple(face_vol[k + 1] ** 2 / (fw[k] * cell_vol) for k in range(dim - 1)) for fw in fw_rest
        ]
        # trans0_m[i][k]: the face above local slab k, then the face below
        # the last slab (the next shard's first); the absent global faces
        # (pad face, bottom boundary) are zero.
        below = shift([t[:1] for t in trans0_p], -1)
        below[-1] = torch.zeros_like(below[-1])
        trans0_m = [torch.cat([t, b], dim=0) for t, b in zip(trans0_p, below)]

        def A(p):
            """A p per block from its 1-slab halo-extended copy: the interior
            axes' stencil, then axis 0, where the flux across face k,
            T_k (p_k - p_{k-1}) in the extended block, enters slab k and
            leaves slab k - 1 (elementwise steps as foreach ops per device)."""
            p_ext = halo_exchange(p, 1, axis=0)
            g = _mul(trans0_m, _by_device(
                lambda hi, lo, i: torch._foreach_sub(hi, lo), [e[1:] for e in p_ext], [e[:-1] for e in p_ext]
            ))
            rest = [_rest_stencil(x, tr) for x, tr in zip(p, trans_rest)]
            return _by_device(
                lambda r, lo, hi, i: torch._foreach_sub(torch._foreach_add(r, lo), hi),
                rest, [x[:-1] for x in g], [x[1:] for x in g],
            )

        diag = []
        for tm, tr in zip(trans0_m, trans_rest):
            d = tm[:-1] + tm[1:]
            for k in range(dim - 1):
                d = d + bk._pad_axis(tr[k], k + 1, 1, 0)
                d = d + bk._pad_axis(tr[k], k + 1, 0, 1)
            diag.append(torch.clamp(d, min=1e-30))
        M = coarse_preconditioner(trans0_p, trans_rest, diag) if use_coarse else None
        return A, diag, M

    def flux_from_pressure(fw0_p, fw_rest, p):
        prev_last = shift([x[-1:] for x in p], 1)
        u0_p, u_rest = [], []
        for x, pl, fw0, fw, pf in zip(p, prev_last, fw0_p, fw_rest, pad_face):
            p_above = torch.cat([pl, x[:-1]], dim=0)
            grad0 = face_vol[0] * (p_above - x)
            u0_p.append(_masked(grad0 / (fw0 * cell_vol), pf, 0.0))
            per_axis = []
            for k in range(dim - 1):
                before, after = _face_pairs(x, k + 1)
                per_axis.append(face_vol[k + 1] * (before - after) / (fw[k] * cell_vol))
            u_rest.append(tuple(per_axis))
        return u0_p, u_rest

    def flatten(u0, ur):
        return torch.cat([u0.reshape(-1)] + [u.reshape(-1) for u in ur])

    def unflatten(flat, pf):
        u0 = _masked(flat[offsets[0] : offsets[1]].reshape(local_shape), pf, 0.0)
        ur = tuple(
            flat[offsets[k + 1] : offsets[k + 2]].reshape(rest_faces_shapes[k]) for k in range(dim - 1)
        )
        return u0, ur

    def solve(mass_diff, return_fluxes: bool = False):
        md = [m.to(torch.float32) for m in placement.split_line(mass_diff)]
        mass_rhs = [cell_vol * m for m in md]
        u0_p = [torch.zeros_like(m) for m in md]
        u_rest = [tuple(torch.zeros(s, dtype=m.dtype, device=m.device) for s in rest_faces_shapes) for m in md]
        p = [torch.zeros_like(m) for m in md]
        flat_size = int(offsets[-1])
        aa_state = [
            {
                "F": torch.zeros((aa_depth, flat_size), dtype=m.dtype, device=m.device),
                "G": torch.zeros((aa_depth, flat_size), dtype=m.dtype, device=m.device),
            }
            for m in md
        ]
        dist_prev = [float("inf")] * num
        distance = dist_prev
        k, converged = 0, False
        while k < num_iter and not converged:
            rho = transport_density(u0_p, u_rest)
            fw0_p, fw_rest = face_weights(rho)
            A, diag, M = tpfa_operator(fw0_p, fw_rest)
            p = projected_pcg_local(A, diag, mass_rhs, cg_tol, cg_maxiter, M=M)
            u0_new, u_rest_new = flux_from_pressure(fw0_p, fw_rest, p)
            if aa_depth > 0:
                xk = [flatten(a, b) for a, b in zip(u0_p, u_rest)]
                gk = [flatten(a, b) for a, b in zip(u0_new, u_rest_new)]
                mixed = _anderson_mix_sharded(aa_state, gk, [g - x for g, x in zip(gk, xk)], k)
                u0_new, u_rest_new = map(list, zip(*(unflatten(m, pf) for m, pf in zip(mixed, pad_face))))
            rho_new = transport_density(u0_new, u_rest_new)
            parts = []
            for r, a, b, ar, br in zip(rho_new, u0_new, u0_p, u_rest_new, u_rest):
                inc = torch.sum((a - b) ** 2) + sum(torch.sum((x - y) ** 2) for x, y in zip(ar, br))
                norm = torch.sum(a**2) + sum(torch.sum(x**2) for x in ar)
                parts.append(torch.stack([torch.sum(r), inc, norm]))
            sums = psum(parts)
            distance = [cell_vol * s[0] for s in sums]
            rel_inc = torch.sqrt(sums[0][1] / torch.clamp(sums[0][2], min=1e-30))
            rel_dist = torch.abs(distance[0] - dist_prev[0]) / torch.clamp(distance[0], min=1e-30)
            flag = (rel_inc < tol_increment) & (rel_dist < tol_distance)
            u0_p, u_rest, dist_prev = u0_new, u_rest_new, distance
            k += 1
            converged = bool(flag)  # the Newton loop's one host read
        dist = distance[0] if isinstance(distance[0], torch.Tensor) else torch.tensor(distance[0])
        pressure = placement.join_line(p)
        if not return_fluxes:
            return dist, pressure, k
        # Per-axis face arrays in the single-device layout: the padded
        # axis-0 block drops the global-boundary pad slot.
        fluxes = (placement.join_line(u0_p)[1:],) + tuple(
            placement.join_line([ur[j] for ur in u_rest]) for j in range(dim - 1)
        )
        return dist, fluxes, pressure, k

    return solve
