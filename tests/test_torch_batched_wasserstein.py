"""Batched W1 (``parallel.batched_wasserstein``) and its batched CG solves
against the JAX package on the CPU.

The JAX package ``vmap``s its fused Newton solve over a leading pair axis;
the port runs the pairs as a leading tensor axis of one loop.  The same
numpy batches go through both: distances within 1e-5 relative, statuses and
Newton iteration counts equal.  The batched CG solves against per-pair calls
(the same CG count per pair, within 1e-6), each pair against the port's
single device-path solve, and the launches of one CG iteration counted at
two batch sizes.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import darsia_tpu_torch as dt
from darsia_tpu.parallel import batched_wasserstein as jax_batched
from darsia_tpu_torch.measure import beckmann_kernels as tbk
from darsia_tpu_torch.parallel import batched_wasserstein

torch.set_num_threads(1)

PARITY = 1e-5
GRID = (12, 20)


def _blocks_batch(n, B, seed=0, noise=0.02):
    """The bench's batch problem (bench.py:499-511) at n x n."""
    q = max(n // 10, 1)
    src0 = np.zeros((n, n))
    src0[2 * q : 5 * q, 2 * q : 5 * q] = 1
    dst0 = np.zeros((n, n))
    dst0[q : 3 * q, q : 2 * q] = 1
    dst0[4 * q : 7 * q, 7 * q : 9 * q] = 1
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(B):
        s = src0 + noise * rng.random((n, n))
        d = dst0 + noise * rng.random((n, n))
        srcs.append(s / (s.sum() / (n * n)))
        dsts.append(d / (d.sum() / (n * n)))
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


def _shifted_batch(seed=5):
    """Four pairs on the 12 x 20 grid: a block moved by four shifts, with
    four noise levels (28, 29, 20 and 47 Newton iterations at the options of
    ``test_pairs_stop_on_their_own_as_in_jax``), and a pair with src == dst."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for shift, noise in (((2, 5), 0.0), ((5, 9), 0.3), ((1, 2), 0.05), ((4, 12), 0.01)):
        s = np.zeros(GRID)
        s[3:6, 3:7] = 1
        d = np.roll(s, shift, axis=(0, 1))
        s = s + noise * rng.random(GRID)
        d = d + noise * rng.random(GRID)
        srcs.append(s / s.sum() * s.size)
        dsts.append(d / d.sum() * d.size)
    srcs.append(srcs[2])
    dsts.append(srcs[2])
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


def _weight():
    yy, xx = np.meshgrid(np.linspace(0, 1, GRID[0]), np.linspace(0, 1, GRID[1]), indexing="ij")
    return (2 + np.sin(3 * xx) * np.cos(2 * yy)).astype(np.float32)


def _both(shape, voxel_size, src, dst, weight=None, options=None):
    """(JAX, port) results, each (distances, iterations, statuses) as numpy."""
    j = jax_batched(shape, voxel_size, weight, options)(jnp.asarray(src), jnp.asarray(dst))
    t = batched_wasserstein(shape, voxel_size, weight, options)(
        torch.from_numpy(src), torch.from_numpy(dst)
    )
    return tuple(np.asarray(a) for a in j), t


def _agree(jax_out, port_out):
    (dj, kj, sj), (dt_, kt, st) = jax_out, port_out
    assert dt_.shape == dj.shape and kt.dtype == np.int32 and st.dtype == np.int32
    assert np.all(np.abs(dt_ - dj) <= PARITY * np.abs(dj).max())
    assert np.array_equal(kt, kj)
    assert np.array_equal(st, sj)


BATCHES = {
    "10x10": lambda: ((10, 10), 0.1, *_blocks_batch(10, 4), None,
                      {"num_iter": 100, "tol_distance": 1e-4}),
    "12x20 weighted": lambda: (GRID, [1 / 12, 1 / 20], *_shifted_batch(), _weight(),
                               {"num_iter": 100, "tol_distance": 1e-5, "tol_increment": 1e-3}),
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_batch_against_jax(name):
    shape, voxel_size, src, dst, weight, options = BATCHES[name]()
    if name == "12x20 weighted":
        src, dst = src[:4], dst[:4]
    jax_out, port_out = _both(shape, voxel_size, src, dst, weight, options)
    _agree(jax_out, port_out)
    assert np.all(port_out[2] == 1)


def test_multigrid_batch_against_jax():
    """``linear_solver="mg"``: the V-cycle hierarchy per pair, its coarsest
    level one (B, n, n) matrix applied as a batched product."""
    src, dst = _blocks_batch(32, 2, seed=1)
    options = {"num_iter": 60, "tol_distance": 1e-4, "linear_solver": "mg"}
    _agree(*_both((32, 32), 1 / 32, src, dst, None, options))


@pytest.fixture(scope="module")
def stopping_batch():
    """The weighted 12 x 20 batch with src == dst as a fifth pair, capped at
    30 Newton iterations: three pairs converge before the cap, one does not."""
    src, dst = _shifted_batch()
    options = {"num_iter": 30, "tol_distance": 1e-5, "tol_increment": 1e-3}
    return _both(GRID, [1 / 12, 1 / 20], src, dst, _weight(), options)


def test_pairs_stop_on_their_own_as_in_jax(stopping_batch):
    jax_out, port_out = stopping_batch
    _agree(jax_out, port_out)
    distances, iterations, statuses = port_out
    assert statuses.tolist() == [1, 1, 1, 0, 1]
    assert iterations[3] == 30 and iterations[:3].max() < 30


def test_a_pair_with_src_equal_dst(stopping_batch):
    """Zero mass difference: distance 0, converged at the first iteration
    that may converge (the third), in both packages."""
    jax_out, port_out = stopping_batch
    assert jax_out[0][4] == port_out[0][4] == 0.0
    assert jax_out[1][4] == port_out[1][4] == 3
    assert jax_out[2][4] == port_out[2][4] == 1


def test_each_pair_against_the_single_device_path():
    """Every pair of a batch against the port's single-pair Newton solve
    (its device path, no Anderson mixing) on the same problem."""
    src, dst = _blocks_batch(10, 3, seed=2)
    options = {"num_iter": 100, "tol_distance": 1e-4}
    distances, iterations, statuses = batched_wasserstein((10, 10), 0.1, None, options)(
        torch.from_numpy(src), torch.from_numpy(dst)
    )
    for i in range(3):
        solver = dt.BeckmannNewtonSolver(dt.Grid((10, 10), 0.1), None, options)
        distance, _, _, info = solver.solve_beckmann_problem(torch.from_numpy(dst[i] - src[i]))
        assert abs(distances[i] - distance) <= PARITY * distance
        assert iterations[i] == info["number_iterations"] + 1
        assert statuses[i] == int(info["converged"])


def _counting(bk, name):
    """Wrap ``bk.<name>`` (a CG loop) to record its iteration counts."""
    counts, original = [], getattr(bk, name)

    def counted(*args, **kwargs):
        out = original(*args, **kwargs)
        counts.append(out[1])
        return out

    return counts, mock.patch.object(bk, name, counted)


def _cg_problem(B, shape=(33, 40), seed=3, batched_trans=True):
    rng = np.random.default_rng(seed)
    lead = (B,) if batched_trans else ()
    faces = [(shape[0] - 1, shape[1]), (shape[0], shape[1] - 1)]
    trans = tuple(
        torch.from_numpy((rng.random(lead + f) * 10 + 0.1).astype(np.float32)) for f in faces
    )
    rhs = torch.from_numpy(rng.standard_normal((B,) + shape).astype(np.float32))
    return trans, rhs


@pytest.mark.parametrize("solver", ["cg", "mg"])
@pytest.mark.parametrize("shared", [False, True], ids=["per-pair trans", "shared trans"])
def test_batched_cg_against_per_pair_calls(solver, shared):
    """A batch of pressure solves against one call per pair: each pair takes
    its own number of CG iterations (as under ``vmap``), the same as alone,
    and its solution agrees within 1e-6 (relative to its largest value)."""
    B, shape = 3, (33, 40)
    trans, rhs = _cg_problem(B, shape, batched_trans=not shared)
    fn, kwargs = (tbk.tpfa_cg, {}) if solver == "cg" else (
        tbk.tpfa_mg_pcg, {"levels": tbk.tpfa_mg_levels(shape)})
    maxiter = 300 if solver == "cg" else 200
    batched_counts, patch_b = _counting(tbk, "iterate_while_batched")
    single_counts, patch_s = _counting(tbk, "iterate_while")
    with patch_b, patch_s:
        xb = fn(trans, rhs, torch.zeros((B,) + shape), 2, 1e-6, maxiter, **kwargs)
        for i in range(B):
            t_i = trans if shared else tuple(t[i] for t in trans)
            xi = fn(t_i, rhs[i], torch.zeros(shape), 2, 1e-6, maxiter, **kwargs)
            assert float((xb[i] - xi).abs().max()) <= 1e-6 * float(xi.abs().max())
    assert batched_counts[0].tolist() == single_counts
    if not shared:
        assert len(set(single_counts)) > 1  # the pairs stop apart


def test_active_mask_holds_pairs_at_the_start():
    """``active`` leaves the pairs it marks False at the projected start
    (the Newton loop's stopped pairs): they take no CG iteration."""
    trans, rhs = _cg_problem(3)
    counts, patch = _counting(tbk, "iterate_while_batched")
    active = torch.tensor([True, False, True])
    with patch:
        x = tbk.tpfa_cg(trans, rhs, torch.zeros_like(rhs), 2, 1e-6, 300, active=active)
    assert counts[0][1] == 0 and counts[0][0] > 0
    assert torch.equal(x[1], torch.zeros_like(x[1]))


class _Launches(TorchDispatchMode):
    """Counts the tensor operations that launch work (views excluded), as
    ``chip_smoke.py``'s op counter does."""

    VIEWS = ("slice", "view", "expand", "permute", "select", "as_strided", "unsqueeze", "alias",
             "transpose", "aten.t.", "unbind", "split", "narrow", "detach", "real", "imag",
             "squeeze", "_local_scalar_dense", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(v in str(func) for v in self.VIEWS):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _launches_per_iteration(trans, rhs, lo=2, hi=4):
    """Launches of one MG-preconditioned CG iteration: the difference of two
    fixed-count solves (tol 0 never stops early)."""
    shape = tuple(rhs.shape[-2:])
    counts = []
    for maxiter in (lo, hi):
        with _Launches() as launches:
            tbk.tpfa_mg_pcg(trans, rhs, torch.zeros_like(rhs), 2, 0.0, maxiter,
                            tbk.tpfa_mg_levels(shape))
        counts.append(launches.n)
    return (counts[1] - counts[0]) / (hi - lo)


def test_launches_per_cg_iteration_do_not_grow_with_the_batch():
    """B = 1 and B = 4 launch the same per CG iteration; against one problem
    without a batch axis, only the mask ops are added (the flags' ``&`` and
    copy, and one ``where`` per state tensor)."""
    per_b = {}
    for B in (1, 4):
        trans, rhs = _cg_problem(B, (17, 20))
        per_b[B] = _launches_per_iteration(trans, rhs)
    trans, rhs = _cg_problem(1, (17, 20))
    single = _launches_per_iteration(tuple(t[0] for t in trans), rhs[0])
    assert per_b[1] == per_b[4]
    assert 0 < per_b[4] - single <= 6


def test_options_inputs_and_refusals():
    """Anderson options are ignored (the JAX package's batch takes the plain
    step); face-based mobility raises; CPU tensors stay on the CPU and a
    numpy batch without a card raises."""
    src, dst = _blocks_batch(10, 2, seed=4)
    options = {"num_iter": 40, "tol_distance": 1e-4}
    plain = batched_wasserstein((10, 10), 0.1, None, options)(
        torch.from_numpy(src), torch.from_numpy(dst)
    )
    mixed = batched_wasserstein((10, 10), 0.1, None, {**options, "aa_depth": 5})(
        torch.from_numpy(src), torch.from_numpy(dst)
    )
    for a, b in zip(plain, mixed):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="traceable"):
        batched_wasserstein((10, 10), 0.1, None, {"mobility_mode": "face_based"})
    solve = batched_wasserstein((10, 10), 0.1, None, options)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            solve(src, dst)
