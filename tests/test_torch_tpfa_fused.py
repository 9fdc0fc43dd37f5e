"""The fused CG trip of the 2D pressure solve (``beckmann_kernels.FusedMGPCG``)
in its plain PyTorch mirror, on the CPU: against the tensor CG that
``tpfa_mg_pcg`` runs here and against the JAX package's ``tpfa_mg_pcg``.

The mirror computes what the kernels of ``csrc/tpfa_mg.cu`` compute, step
for step (their card tests hold them to it: ``tests/test_torch_gpu_tpfa.py``).
Tolerances: to a tolerance of 1e-6, 1e-5 relative to the solution's largest
value, with each pair's trips within 2 of the tensor CG's (the mirror forms
<r, z> and the projections from float64 sums, the tensor CG from float32
dot products); with a fixed trip count (tol 0), 1e-5 and the same trips.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darsia_tpu.measure import beckmann_kernels as jbk
from darsia_tpu_torch.measure import beckmann_kernels as tbk
from darsia_tpu_torch.utils import tracing

torch.set_num_threads(1)

SOLVE_TOL = 1e-5
ODD_SHAPES = [(33, 41), (17, 23), (40, 31), (9, 64)]


def _problem(B, shape, shared, seed=3):
    """Transmissibilities over three decades and a right-hand side, as numpy
    float32 (shared: no batch axis on the faces)."""
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)
    faces = [(shape[0] - 1, shape[1]), (shape[0], shape[1] - 1)]
    trans = tuple((10.0 ** rng.uniform(-1.5, 1.5, lead + f)).astype(np.float32) for f in faces)
    rhs = rng.standard_normal((B,) + shape).astype(np.float32)
    return trans, rhs


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, tol=SOLVE_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol:.0e} x {scale:.3e}"


def _tensor_cg(trans, rhs, levels, tol, maxiter, active=None, nu=2):
    """``tpfa_mg_pcg`` on the CPU (the tensor CG) and each pair's trips."""
    counts, original = [], tbk.iterate_while_batched

    def counted(*args, **kwargs):
        out = original(*args, **kwargs)
        counts.append(out[1])
        return out

    with mock.patch.object(tbk, "iterate_while_batched", counted):
        x = tbk.tpfa_mg_pcg(trans, rhs, torch.zeros_like(rhs), 2, tol, maxiter, levels, nu,
                            active=active)
    return x, counts[0]


def _mirror(trans, rhs, levels, tol, maxiter, active=None, nu=2):
    hierarchy = tbk.tpfa_mg_hierarchy(trans, 2, levels, nu)
    return tbk.mg_pcg_fused(hierarchy, rhs, torch.zeros_like(rhs), tol, maxiter, nu, 40, active,
                            kernels=False)


@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
@pytest.mark.parametrize("shared", [False, True], ids=["per-pair", "shared"])
def test_mirror_matches_the_tensor_cg_and_jax(shape, shared):
    """A batch of 5 with pair 1 held from the start: the mirror against the
    tensor CG (each pair's trips within 2) and against the JAX package's
    solve of each active pair alone; the held pair stays at zero."""
    B = 5
    trans_np, rhs_np = _problem(B, shape, shared)
    trans, rhs = _t(trans_np), torch.from_numpy(rhs_np)
    levels = tbk.tpfa_mg_levels(shape, coarsest=2)
    active = torch.tensor([True, False, True, True, True])
    got, trips = _mirror(trans, rhs, levels, 1e-6, 200, active)
    want, want_trips = _tensor_cg(trans, rhs, levels, 1e-6, 200, active)
    assert trips[1] == want_trips[1] == 0
    assert np.all(np.abs(trips - want_trips) <= 2) and trips.max() > 0
    assert torch.equal(got[1], torch.zeros(shape))
    for i in (0, 2, 3, 4):
        _close(got[i], want[i])
        t_i = trans_np if shared else tuple(t[i] for t in trans_np)
        j = jbk.tpfa_mg_pcg(tuple(jnp.asarray(t) for t in t_i), jnp.asarray(rhs_np[i]),
                            jnp.zeros(shape, jnp.float32), dim=2, tol=1e-6, maxiter=200,
                            levels=levels)
        _close(got[i], np.asarray(j))


@pytest.mark.parametrize("shape", [(33, 41), (64, 70)], ids=str)
def test_mirror_of_one_problem_matches_the_tensor_cg_and_jax(shape):
    """One problem without a batch axis (viewed as a batch of one)."""
    trans_np, rhs_np = _problem(1, shape, shared=True)
    trans, rhs = _t(trans_np), torch.from_numpy(rhs_np[0])
    levels = tbk.tpfa_mg_levels(shape)
    got, trips = _mirror(trans, rhs, levels, 1e-6, 200)
    assert got.shape == shape and trips.shape == (1,)
    counts, original = [], tbk.iterate_while

    def counted(*args, **kwargs):
        out = original(*args, **kwargs)
        counts.append(out[1])
        return out

    with mock.patch.object(tbk, "iterate_while", counted):
        want = tbk.tpfa_mg_pcg(trans, rhs, torch.zeros_like(rhs), 2, 1e-6, 200, levels)
    _close(got, want)
    assert abs(int(trips[0]) - counts[0]) <= 2
    j = jbk.tpfa_mg_pcg(tuple(jnp.asarray(t) for t in trans_np), jnp.asarray(rhs_np[0]),
                        jnp.zeros(shape, jnp.float32), dim=2, tol=1e-6, maxiter=200, levels=levels)
    _close(got, np.asarray(j))


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("shared", [False, True], ids=["per-pair", "shared"])
def test_mirror_with_a_fixed_trip_count(nu, shared):
    """tol 0 runs exactly ``maxiter`` trips in both; the smoother's sweep
    count ``nu`` is the kernels' halo."""
    B, shape = 3, (21, 34)
    trans_np, rhs_np = _problem(B, shape, shared, seed=nu)
    trans, rhs = _t(trans_np), torch.from_numpy(rhs_np)
    levels = tbk.tpfa_mg_levels(shape, coarsest=2)
    got, trips = _mirror(trans, rhs, levels, 0.0, 6, nu=nu)
    want, want_trips = _tensor_cg(trans, rhs, levels, 0.0, 6, nu=nu)
    assert trips.tolist() == want_trips.tolist() == [6] * B
    _close(got, want)


def test_finalize_rejects_an_update_whose_x_is_not_finite():
    """_pcg's rule: an update that makes x non-finite is rejected (x and r
    keep their buffer, |r| its value) while rz takes the new value; the
    stopping rule then reads the kept |r| and the new rz."""
    B, shape = 3, (9, 10)
    trans_np, rhs_np = _problem(B, shape, shared=False)
    hierarchy = tbk.tpfa_mg_hierarchy(_t(trans_np), 2, 2)
    s = tbk.FusedMGPCG(hierarchy, B, shape, 2, 40, kernels=False)
    s.start(torch.from_numpy(rhs_np), torch.zeros(B, *shape), 1e-6)
    s.apply()
    s.update()
    s.vcycle(flip=1)
    s.direction()
    s.part_u[1, 0, 1] = float("inf")  # pair 1's |x|^2
    s.rz_next[2] = float("nan")  # pair 2's new rz: it stops
    sel, mx, rn = s.sel.clone(), s.mx.clone(), s.rn.clone()
    s.finalize()
    assert s.sel.tolist() == [1 - int(sel[0]), int(sel[1]), 1 - int(sel[2])]
    assert s.mx[1] == mx[1] and s.rn[1] == rn[1] and s.rn[0] != rn[0]
    assert s.rz[0] == s.rz_next[0] and s.rz[1] == s.rz_next[1] and torch.isnan(s.rz[2])
    assert s.act.tolist() == [1, 1, 0]


@pytest.mark.parametrize("h,w", [(120, 280), (60, 140), (30, 70), (15, 35), (8, 18), (33, 41),
                                 (1, 5), (512, 512), (1788, 3180)])
@pytest.mark.parametrize("halo", [1, 2, 3, 5])
def test_v_cycle_tiles_cover_each_level(h, w, halo):
    """Even tiles (whole 2x2 aggregates) that cover the level, each with
    its halo inside the kernels' shared memory."""
    th, tw, nh, nw = tbk._mg_tile(h, w, halo)
    assert th % 2 == 0 and tw % 2 == 0
    assert nh == -(-h // th) and nw == -(-w // tw)
    assert (th + 2 * halo) * (tw + 2 * halo) <= tbk._TILE_CELLS


@pytest.mark.parametrize("case", ["cpu 2d batch", "cpu 2d single", "3d"])
def test_the_cpu_and_3d_take_the_tensor_cg(case):
    """On the CPU, and in 3D, ``tpfa_mg_pcg`` runs the tensor CG: the kernels'
    loop is never entered and ``beckmann.mg_kernel_trips`` does not move,
    while ``beckmann.cg_trips`` counts the trips."""
    shape = (9, 8, 7) if case == "3d" else (17, 20)
    rng = np.random.default_rng(1)
    trans = tuple(
        torch.from_numpy(rng.uniform(0.5, 2.0, shape[:d] + (shape[d] - 1,) + shape[d + 1:])
                         .astype(np.float32))
        for d in range(len(shape))
    )
    rhs = torch.from_numpy(rng.standard_normal(((3,) if case == "cpu 2d batch" else ()) + shape)
                           .astype(np.float32))
    levels = tbk.tpfa_mg_levels(shape, coarsest=2)
    before = {c: tracing.counter(c) for c in ("beckmann.cg_trips", "beckmann.mg_kernel_trips")}
    with mock.patch.object(tbk, "mg_pcg_fused", side_effect=AssertionError("fused path taken")):
        x = tbk.tpfa_mg_pcg(trans, rhs, torch.zeros_like(rhs), len(shape), 1e-6, 200, levels)
    assert x.shape == rhs.shape and bool(torch.isfinite(x).all())
    assert tracing.counter("beckmann.cg_trips") > before["beckmann.cg_trips"]
    assert tracing.counter("beckmann.mg_kernel_trips") == before["beckmann.mg_kernel_trips"]
