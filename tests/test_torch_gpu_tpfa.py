"""The pressure solve's CG-trip kernels (``csrc/tpfa_mg.cu``) against their
plain PyTorch mirror (``beckmann_kernels.FusedMGPCG(kernels=False)``).

Needs a CUDA card (marked ``gpu``; skipped elsewhere).  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_tpfa.py

Tolerances: the kernels contract multiply-adds and sum per block in float32
before a float64 total; the mirror sums in float64 whole.  A stencil pass
differs from its mirror by a few float32 roundings of its largest term
(1e-5 of the output's largest value); a solve, at rtol 1e-6, by what two CG
runs to that tolerance may differ (1e-5 of the solution's largest value),
with trips within 2.
"""

import numpy as np
import pytest
import torch

from darsia_tpu_torch.measure import beckmann_kernels as bk
from darsia_tpu_torch.utils import tracing

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

#: The levels of the benchmark's 120 x 280 grid, then odd tails in both axes.
LEVEL_SHAPES = [(120, 280), (60, 140), (30, 70), (15, 35), (8, 18)]
ODD_SHAPES = [(33, 41), (17, 9), (7, 13)]
STEP_TOL = 1e-5
SOLVE_TOL = 1e-5


def _problem(B, shape, shared, seed=3, device="cuda"):
    """Transmissibilities of a 1/|u|-like weight (three decades) and a
    zero-mean right-hand side, on ``device``."""
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)
    faces = [(shape[0] - 1, shape[1]), (shape[0], shape[1] - 1)]
    trans = tuple(
        torch.from_numpy((10.0 ** rng.uniform(-1.5, 1.5, lead + f)).astype(np.float32)).to(device)
        for f in faces
    )
    rhs = torch.from_numpy(rng.standard_normal((B,) + shape).astype(np.float32)).to(device)
    return trans, rhs


def _pair(B, shape, shared, nu=2):
    """A kernel solver and its mirror on one problem, both started."""
    trans, rhs = _problem(B, shape, shared)
    levels = bk.tpfa_mg_levels(shape, coarsest=2)
    hierarchy = bk.tpfa_mg_hierarchy(trans, 2, levels, nu)
    out = []
    for kernels in (True, False):
        s = bk.FusedMGPCG(hierarchy, B, shape, nu, 40, kernels=kernels)
        s.start(rhs, torch.zeros_like(rhs), 1e-6)
        out.append(s)
    return out


STATE = ("X", "R", "P", "AP", "Z", "sel", "mx", "rn", "rz", "rz_next", "thr", "act")


def _copy_state(dst, src):
    for name in STATE:
        getattr(dst, name).copy_(getattr(src, name))
    for name in ("part_a", "part_u", "part_v"):
        d, s = getattr(dst, name), getattr(src, name)
        d.zero_()
        d[:, 0] = s.sum(dim=1)


def _close(got, want, tol=STEP_TOL):
    scale = float(want.abs().max()) or 1.0
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol:.0e} x {scale:.3e}"


def _sums(part):
    return part.sum(dim=1)


CASES = [(s, B, shared) for s in LEVEL_SHAPES + ODD_SHAPES for B in (1, 7) for shared in (False, True)]
CASES += [((120, 280), 1024, False), ((120, 280), 1024, True)]


@pytest.mark.parametrize("shape,B,shared", CASES, ids=str)
def test_each_step_matches_the_mirror(shape, B, shared):
    """Start both from one state, then each step of a trip from the mirror's
    state: A p, the update, the V-cycle, the direction, the trip's end."""
    ker, ref = _pair(B, shape, shared)
    _close(ker.Z, ref.Z)
    _close(_sums(ker.part_v), _sums(ref.part_v))
    for step in ("apply", "update", "vcycle", "direction", "finalize"):
        _copy_state(ker, ref)
        for s in (ker, ref):
            getattr(s, step)(*((1,) if step == "vcycle" else ()))
        torch.cuda.synchronize()
        if step == "apply":
            _close(ker.AP, ref.AP)
            _close(_sums(ker.part_a), _sums(ref.part_a))
        elif step == "update":
            _close(ker.X, ref.X)
            _close(ker.R, ref.R)
            _close(_sums(ker.part_u), _sums(ref.part_u))
        elif step == "vcycle":
            _close(ker.Z, ref.Z)
            _close(_sums(ker.part_v), _sums(ref.part_v))
        elif step == "direction":
            _close(ker.P, ref.P)
            _close(ker.rz_next, ref.rz_next)
        else:
            for name in ("sel", "act"):
                assert torch.equal(getattr(ker, name), getattr(ref, name)), name
            for name in ("mx", "rn", "rz"):
                _close(getattr(ker, name), getattr(ref, name))


@pytest.mark.parametrize("shape", LEVEL_SHAPES + ODD_SHAPES, ids=str)
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_level_kernels_match_the_mirror(shape, nu):
    """One level's pre pass (``nu`` sweeps from zero, residual, restriction)
    and post pass (the pre pass's x plus the prolonged correction, ``nu``
    sweeps) against the tensor V-cycle's own steps, on per-pair
    transmissibilities."""
    B = 7
    trans, rhs = _problem(B, shape, shared=False, seed=nu)
    hierarchy = bk.tpfa_mg_hierarchy(trans, 2, 2, nu)
    solver = bk.FusedMGPCG(hierarchy, B, shape, nu, 40, kernels=True)
    solver.R[0].copy_(rhs)
    solver.act.fill_(1)
    t, step = hierarchy.trans[0], hierarchy.steps[0]
    solver._launch(*solver._pre[0][0])
    x = bk._tpfa_sweeps(None, rhs, t, step, 2, nu)
    want_rc = bk._restrict_cells(bk._tpfa_residual(x, rhs, t, 2), 2)
    torch.cuda.synchronize()
    _close(solver.rc[1].float(), want_rc)
    ec = torch.randn(solver.zl[1].shape, device="cuda", generator=torch.Generator("cuda").manual_seed(nu))
    solver.zl[1].copy_(ec)
    solver._launch(*solver._post[0][0])
    ec = solver.zl[1].float()
    want = bk._tpfa_sweeps(x + bk._prolong_cells(ec, tuple(rhs.shape), 2), rhs, t, step, 2, nu)
    torch.cuda.synchronize()
    _close(solver.Z, want)


@pytest.mark.parametrize("shape", [(4, 9), (8, 18), (5, 7), (1, 6), (32, 32)], ids=str)
@pytest.mark.parametrize("shared", [False, True], ids=["per-pair", "shared"])
def test_coarse_matrix_kernel_matches_the_tensor_build(shape, shared):
    """The coarsest level's float64 matrix (42 sweeps on each unit vector)
    built by the kernel against ``tpfa_mg_hierarchy``'s tensor sweeps: the
    same sums, contracted into multiply-adds (1e-12 relative)."""
    trans, _ = _problem(7, shape, shared)
    want = bk.tpfa_mg_hierarchy(trans, 2, 1)
    got = bk.mg_hierarchy_on_card(trans, 1)
    torch.cuda.synchronize()
    assert got.coarse.shape == want.coarse.shape == ((7,) if not shared else ()) + (shape[0] * shape[1],) * 2
    scale = float(want.coarse.abs().max())
    assert float((got.coarse - want.coarse).abs().max()) <= 1e-12 * scale
    assert all(torch.equal(a, b) for a, b in zip(got.steps, want.steps))


def test_inactive_pairs_keep_their_state_bit_for_bit():
    B, shape = 7, (33, 41)
    ker, _ = _pair(B, shape, shared=False)
    ker.act.copy_(torch.tensor([1, 0, 1, 0, 0, 1, 1], dtype=torch.uint8))
    idle = ~ker.act.bool()
    before = {name: getattr(ker, name).clone() for name in STATE}
    ker.trip()
    torch.cuda.synchronize()
    for name, old in before.items():
        new = getattr(ker, name)
        if name in ("X", "R"):
            old, new = old[:, idle], new[:, idle]
        else:
            old, new = old[idle], new[idle]
        assert torch.equal(new, old), name
    assert not torch.equal(ker.P[~idle], before["P"][~idle])


@pytest.mark.parametrize("shared", [False, True], ids=["per-pair", "shared"])
def test_two_solves_are_bitwise_equal(shared):
    trans, rhs = _problem(64, (120, 280), shared)
    hierarchy = bk.tpfa_mg_hierarchy(trans, 2, bk.tpfa_mg_levels((120, 280)))
    runs = [bk.mg_pcg_fused(hierarchy, rhs, torch.zeros_like(rhs), 1e-6, 200) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize(
    "B,shape,shared",
    [(1, (120, 280), False), (7, (33, 41), False), (7, (33, 41), True), (32, (120, 280), False)],
    ids=str,
)
def test_solve_on_the_card_matches_the_cpu(B, shape, shared):
    """``tpfa_mg_pcg`` on the card (the kernels) against the CPU (the tensor
    code) and the mirror on the card, with masked pairs; one problem
    without a batch axis at B = 1."""
    trans, rhs = _problem(B, shape, shared)
    levels = bk.tpfa_mg_levels(shape)
    active = None
    if B > 1:
        active = torch.ones(B, dtype=torch.bool)
        active[1] = False
    if B == 1:
        rhs = rhs[0]
        trans = tuple(t[0] for t in trans) if not shared else trans
    rhs_cpu, trans_cpu = rhs.cpu(), tuple(t.cpu() for t in trans)
    want = bk.tpfa_mg_pcg(trans_cpu, rhs_cpu, torch.zeros_like(rhs_cpu), 2, 1e-6, 200, levels,
                          active=active)
    trips_before = tracing.counter("beckmann.cg_trips")
    kernel_before = tracing.counter("beckmann.mg_kernel_trips")
    got = bk.tpfa_mg_pcg(trans, rhs, torch.zeros_like(rhs), 2, 1e-6, 200, levels,
                         active=None if active is None else active.cuda())
    trips = tracing.counter("beckmann.cg_trips") - trips_before
    assert trips > 0 and tracing.counter("beckmann.mg_kernel_trips") - kernel_before == trips
    _close(got.cpu(), want, SOLVE_TOL)
    if active is not None:
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    hierarchy = bk.tpfa_mg_hierarchy(trans, 2, levels)
    mirror, counts = bk.mg_pcg_fused(hierarchy, rhs, torch.zeros_like(rhs), 1e-6, 200,
                                     active=None if active is None else active.cuda(), kernels=False)
    _close(got, mirror, SOLVE_TOL)
    assert abs(trips - int(counts.max())) <= 2


def test_card_trips_count_as_kernel_trips_in_a_batched_w1():
    """A batched W1 solve on the card counts every CG trip as a kernel trip."""
    from darsia_tpu_torch.parallel import batched_wasserstein

    rng = np.random.default_rng(5)
    shape = (64, 96)
    maps = rng.random((2, 4) + shape).astype(np.float32) + 0.05
    maps /= maps.sum(axis=(2, 3), keepdims=True) / (shape[0] * shape[1])
    src, dst = (torch.from_numpy(m).cuda() for m in maps)
    solve = batched_wasserstein(shape, 1.0 / shape[1], None, {"num_iter": 20, "tol_distance": 1e-4})
    trips, kernels = (tracing.counter(c) for c in ("beckmann.cg_trips", "beckmann.mg_kernel_trips"))
    distances, _, statuses = solve(src, dst)
    trips = tracing.counter("beckmann.cg_trips") - trips
    assert trips > 0 and tracing.counter("beckmann.mg_kernel_trips") - kernels == trips
    assert np.all(np.isfinite(distances))
