"""Batched Wasserstein-1 solves: many pairs in one Newton loop per device.

Counterpart of :mod:`darsia_tpu.parallel.wasserstein`'s
``batched_wasserstein``.  The JAX package ``vmap``s its fused Newton solve
over a leading axis of mass pairs; here the pairs are that leading axis of
every tensor of the Newton loop (:meth:`BeckmannProblem._device_loop`) and of
its pressure solves (:func:`~darsia_tpu_torch.measure.beckmann_kernels.tpfa_mg_pcg`,
:func:`~darsia_tpu_torch.measure.beckmann_kernels.tpfa_cg`), so each launch
serves every pair.  Each pair keeps its own stopping rules, as under
``vmap``: its CG solves stop on its own threshold, its Newton loop on its own
criteria, and a pair that has stopped keeps its state while the others run.
The host reads one ``(B, 5)`` metrics tensor per Newton iteration and one
``(B,)`` flag vector per CG iteration.

``sharded_wasserstein_batch`` splits the pairs over one axis of a device
mesh: each position runs this batched loop on its own pairs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..image.image import as_tensor
from ..measure.beckmann import BeckmannNewtonSolver
from ..utils import tracing
from ..utils.grid import Grid
from .mesh import Mesh, Placement

__all__ = ["batched_wasserstein", "sharded_wasserstein_batch"]


def _make_batch_solve(solver: BeckmannNewtonSolver):
    """``mass_diff (B, *shape) -> (distances, iterations, statuses)`` from the
    solver's Newton machinery, as the JAX package's ``_make_single_solve``
    under ``vmap``: the Darcy initialisation with ``L_init`` weights, then the
    plain Newton step (no Anderson mixing) in the device loop."""
    if not solver._traceable_mobility():
        raise ValueError("batched Wasserstein requires a traceable (cell-based) mobility mode")
    L_init = float(solver.options.get("L_init", 1.0))

    def solve(mass_diff: torch.Tensor):
        with tracing.span("beckmann.solve", mass_diff.device, pairs=int(mass_diff.shape[0])):
            mass_rhs = solver.cell_vol * mass_diff.to(solver.dtype)
            c = solver._constants(mass_rhs.device)
            face_weights = tuple(L_init * w for w in c.base_face_weights)
            p = torch.zeros_like(mass_rhs)
            p = solver.pressure_solve(face_weights, mass_rhs, p)
            fluxes = solver.flux_from_pressure(face_weights, p)
            distance0 = solver._l1(fluxes).cpu().numpy()

            def step(state, k, running):
                return solver._newton_step(state, k, mass_rhs, True, running)

            _, distances, statuses, steps = solver._device_loop(
                step, (fluxes, p, None), distance0, 0.0
            )
        return distances, steps.astype(np.int32), statuses

    return solve


def batched_wasserstein(
    grid_shape: tuple,
    voxel_size=1.0,
    weight=None,
    options: Optional[dict] = None,
):
    """``solve(src_batch, dst_batch) -> (distances, iterations, statuses)``.

    ``src_batch``/``dst_batch`` have shape ``(B, *grid_shape)``; masses are
    assumed normalized per pair (as in ``wasserstein_distance``).  Tensors
    stay on their device; numpy arrays go to the CUDA card (without one that
    raises: pass CPU tensors to solve on the CPU).  The three results are
    ``(B,)`` numpy arrays: the distances (in the solve's dtype), the Newton
    iterations each pair took, and each pair's status (0: iteration cap, 1:
    converged, 2: stopped on a non-finite iterate, the previous one kept).

    As in the JAX package, the mobility must be cell-based (traceable) and the
    Newton step is the plain one: no Anderson mixing, even where ``options``
    ask for it.
    """
    solver = BeckmannNewtonSolver(
        Grid(tuple(grid_shape), voxel_size), weight, dict(options or {})
    )
    solve_diff = _make_batch_solve(solver)

    def solve(src_batch, dst_batch):
        src = as_tensor(src_batch)
        dst = as_tensor(dst_batch, src.device)
        return solve_diff(dst - src)

    return solve


def sharded_wasserstein_batch(
    mesh: Mesh,
    grid_shape: tuple,
    voxel_size=1.0,
    weight=None,
    options: Optional[dict] = None,
    axis: Optional[str] = None,
):
    """Batch-sharded W1: the pairs split over the ``axis`` mesh axis.

    Returns ``solve(src_batch, dst_batch) -> (distances, iterations,
    statuses)`` (as :func:`batched_wasserstein`'s) where each mesh position
    runs the batched Newton loop on its own pairs, on its device, one
    position after the other.  ``B`` must divide by the axis size; other
    mesh axes must have size 1.
    """
    axis = axis or mesh.axis_names[0]
    mesh.line(axis)
    solver = BeckmannNewtonSolver(
        Grid(tuple(grid_shape), voxel_size), weight, dict(options or {})
    )
    solve_diff = _make_batch_solve(solver)
    placement = Placement(mesh, (axis,) + (None,) * len(grid_shape))

    def solve(src_batch, dst_batch):
        src = placement.split_line(src_batch)
        dst = placement.split_line(dst_batch)
        parts = [solve_diff(d - s) for s, d in zip(src, dst)]
        return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))

    return solve
