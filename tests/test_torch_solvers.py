"""The port's stencils and solvers against the JAX package, on the CPU.

Same numpy inputs (made from a seed) to both packages.  Tolerances on
unit-range float32 images: the stencils are the same elementwise float32
arithmetic, held to 1e-6; fixed-count Jacobi and multigrid runs accumulate
rounding over their sweeps, held to 2e-6; CG and the tolerance-driven loops
reduce in another order in the two libraries (they may stop an iteration
apart), so their solutions are held to 1e-5 and their counts are not
compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.ops import solvers as jsolvers
from darsia_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(1)

STENCIL_TOL = 1e-6
SWEEP_TOL = 2e-6
LOOP_TOL = 1e-5


def record_host_reads(monkeypatch) -> list:
    """Record every device -> host read of a tensor (on the CPU the same
    calls a CUDA tensor would make): the methods that copy, and the
    conversions to Python numbers that go through them."""
    reads = []
    for name in ("numpy", "cpu", "tolist", "item", "__bool__", "__float__", "__int__", "__index__"):
        original = getattr(torch.Tensor, name)

        def record(self, *args, _original=original, _name=name, **kwargs):
            reads.append((_name, tuple(self.shape)))
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, record)
    return reads


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    mass = (0.5 + rng.random(shape)).astype(np.float32)
    diff = (0.2 + rng.random(shape)).astype(np.float32)
    return x, mass, diff


def _both(value):
    """A coefficient for the JAX package and for the port."""
    if isinstance(value, np.ndarray):
        return jnp.asarray(value), torch.from_numpy(value)
    return value, value


SHAPES = {2: (37, 50), 3: (11, 14, 9)}


# --------------------------------------------------------------- stencils


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", ["backward_diff", "forward_diff"])
def test_one_sided_differences_against_jax(name, dim):
    x, _, _ = _fields(SHAPES[dim])
    for axis in range(dim):
        for h in (None, 0.25):
            want = np.asarray(getattr(da, name)(jnp.asarray(x), axis, dim, h))
            got = getattr(dt, name)(torch.from_numpy(x), axis, dim, h).numpy()
            assert np.abs(got - want).max() <= STENCIL_TOL * max(1.0, np.abs(want).max())
    closed = getattr(dt, name)(torch.from_numpy(x), 0, dim).numpy()
    assert np.all(closed[-1 if name == "backward_diff" else 0] == 0)
    with pytest.raises(ValueError):
        getattr(dt, name)(torch.from_numpy(x), dim, dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("field", [False, True], ids=["scalar_D", "field_D"])
@pytest.mark.parametrize("name", ["laplace", "fv_laplace"])
def test_laplacians_against_jax(name, field, dim):
    x, _, diff = _fields(SHAPES[dim], seed=1)
    dj, dtt = _both(diff if field else 0.7)
    for axis in (None, dim - 1):
        for h in (None, 0.5):
            want = np.asarray(
                getattr(da, name)(jnp.asarray(x), axis=axis, dim=dim, h=h, diffusion_coeff=dj)
            )
            got = getattr(dt, name)(
                torch.from_numpy(x), axis=axis, dim=dim, h=h, diffusion_coeff=dtt
            ).numpy()
            assert np.abs(got - want).max() <= STENCIL_TOL * max(1.0, np.abs(want).max())


def test_fv_laplace_batches_trailing_axes():
    """Trailing axes are batch: each channel equals the channel alone, also
    with a diffusion field broadcast over the channels."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((13, 17, 3)).astype(np.float32))
    d = torch.from_numpy((0.2 + rng.random((13, 17))).astype(np.float32))
    batched = dt.fv_laplace(x, dim=2, diffusion_coeff=d[..., None])
    for c in range(3):
        assert torch.equal(batched[..., c], dt.fv_laplace(x[..., c], dim=2, diffusion_coeff=d))


def test_laplace_closure_differs_from_fv_laplace_as_in_jax():
    """``laplace`` keeps the one-sided closures of the JAX package
    (darsia_tpu/utils/derivatives.py:38-64, noted there at :47-51): on a
    constant-gradient image its boundary rows are -/+ 0.5, where the
    zero-flux ``fv_laplace`` gives +/- 1; both are mirrored, not repaired."""
    ramp = np.arange(6, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    for pkg, arr in ((da, jnp.asarray(ramp)), (dt, torch.from_numpy(ramp))):
        lap = np.asarray(pkg.laplace(arr, axis=0))
        fv = np.asarray(pkg.fv_laplace(arr, axis=0))
        assert np.allclose(lap[:, 0], [0.5, 0, 0, 0, 0, -0.5])
        assert np.allclose(fv[:, 0], [1, 0, 0, 0, 0, -1])


# ------------------------------------------------------------ the solvers


@pytest.mark.parametrize("field", [False, True], ids=["scalar", "field"])
@pytest.mark.parametrize("dim", [2, 3])
def test_operator_diagonal_against_jax(dim, field):
    shape = SHAPES[dim]
    _, mass, diff = _fields(shape, seed=3)
    (mj, mt), (dj, dtt) = _both(mass if field else 0.2), _both(diff if field else 1.3)
    want = np.asarray(jsolvers.operator_diagonal(mj, dj, shape, dim, 0.5))
    got = tsolvers.operator_diagonal(mt, dtt, shape, dim, 0.5, "cpu").numpy()
    assert np.abs(got - want).max() <= STENCIL_TOL * np.abs(want).max()


@pytest.mark.parametrize("field", [False, True], ids=["scalar", "field"])
@pytest.mark.parametrize("dim", [2, 3])
def test_jacobi_solve_fixed_count_against_jax(dim, field):
    x, mass, diff = _fields(SHAPES[dim], seed=4)
    (mj, mt), (dj, dtt) = _both(mass if field else 0.2), _both(diff if field else 1.0)
    want = np.asarray(
        jsolvers.jacobi_solve(jnp.asarray(x), jnp.asarray(mass * x), mj, dj, dim=dim, maxiter=25)
    )
    got = tsolvers.jacobi_solve(
        torch.from_numpy(x), torch.from_numpy(mass * x), mt, dtt, dim=dim, maxiter=25
    ).numpy()
    assert np.abs(got - want).max() <= SWEEP_TOL


@pytest.mark.parametrize("field", [False, True], ids=["scalar", "field"])
@pytest.mark.parametrize("dim", [2, 3])
def test_cg_solve_against_jax(dim, field):
    x, mass, diff = _fields(SHAPES[dim], seed=5)
    (mj, mt), (dj, dtt) = _both(mass if field else 0.2), _both(diff if field else 1.0)
    for maxiter, tol in ((12, 1e-30), (200, 1e-6)):
        want = np.asarray(
            jsolvers.cg_solve(
                jnp.asarray(x), jnp.asarray(mass * x), mj, dj, dim=dim, tol=tol, maxiter=maxiter
            )
        )
        got = tsolvers.cg_solve(
            torch.from_numpy(x), torch.from_numpy(mass * x), mt, dtt, dim=dim, tol=tol,
            maxiter=maxiter,
        ).numpy()
        assert np.abs(got - want).max() <= LOOP_TOL


@pytest.mark.parametrize("shape", [(37, 50), (64, 48), (5, 9), (11, 14, 9)], ids=str)
def test_restrict_and_prolong_against_jax(shape):
    """Odd extents: restriction drops the trailing odd entry, prolongation
    edge-pads back to the target."""
    dim = len(shape)
    x, _, _ = _fields(shape, seed=6)
    coarse_j = jsolvers._restrict(jnp.asarray(x), dim)
    coarse_t = tsolvers._restrict(torch.from_numpy(x), dim)
    assert tuple(coarse_t.shape) == tuple(n // 2 for n in shape)
    assert np.array_equal(coarse_t.numpy(), np.asarray(coarse_j))
    fine_j = jsolvers._prolong(coarse_j, shape, dim)
    fine_t = tsolvers._prolong(coarse_t, shape, dim)
    assert tuple(fine_t.shape) == shape
    assert np.array_equal(fine_t.numpy(), np.asarray(fine_j))


def test_coefficient_pyramid_against_jax():
    _, mass, _ = _fields((37, 50), seed=7)
    pyr_j = jsolvers.build_coefficient_pyramid(jnp.asarray(mass), (37, 50), 2, 3)
    pyr_t = tsolvers.build_coefficient_pyramid(torch.from_numpy(mass), (37, 50), 2, 3)
    assert [tuple(p.shape) for p in pyr_t] == [(37, 50), (18, 25), (9, 12), (4, 6)]
    for pj, pt in zip(pyr_j, pyr_t):
        assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert tsolvers.build_coefficient_pyramid(0.3, (37, 50), 2, 2) == [0.3, 0.3, 0.3]


@pytest.mark.parametrize(
    "shape, field",
    [((37, 50), True), ((37, 50), False), ((64, 48), True), ((11, 14, 9), True)],
    ids=["odd_field", "odd_scalar", "even_field", "3d_field"],
)
def test_mg_fixed_count_against_jax(shape, field):
    dim = len(shape)
    x, mass, diff = _fields(shape, seed=8)
    coeffs = {"mass_coeff": mass if field else 0.4, "diffusion_coeff": diff if field else 0.9}
    kw = {"depth": 3, "smoother_iterations": 3, "maxiter": 4, "dim": dim}
    want = np.asarray(da.MG(**kw, **coeffs)(jnp.asarray(x), jnp.asarray(mass * x)))
    got = dt.MG(**kw, **coeffs)(torch.from_numpy(x), torch.from_numpy(mass * x)).numpy()
    assert np.abs(got - want).max() <= SWEEP_TOL


def test_mg_with_tolerance_against_jax():
    x, mass, diff = _fields((37, 50), seed=9)
    kw = {"depth": 2, "maxiter": 40, "tol": 1e-4, "mass_coeff": mass, "diffusion_coeff": diff}
    want = np.asarray(da.MG(**kw)(jnp.asarray(x), jnp.asarray(mass * x)))
    got = dt.MG(**kw)(torch.from_numpy(x), torch.from_numpy(mass * x)).numpy()
    assert np.abs(got - want).max() <= LOOP_TOL


def test_mg_depth_is_clamped_as_in_jax():
    """A depth the grid cannot carry is clamped (darsia_tpu
    utils/linear_solvers/__init__.py:138-139): the result equals the JAX
    package's and the depth that fits."""
    x, mass, _ = _fields((9, 12), seed=10)
    rhs = torch.from_numpy(mass * x)
    deep = dt.MG(depth=9, maxiter=2)(torch.from_numpy(x), rhs)
    assert tsolvers.clamp_depth(9, (9, 12), 2) == 2
    assert torch.equal(deep, dt.MG(depth=2, maxiter=2)(torch.from_numpy(x), rhs))
    want = np.asarray(da.MG(depth=9, maxiter=2)(jnp.asarray(x), jnp.asarray(mass * x)))
    assert np.abs(deep.numpy() - want).max() <= SWEEP_TOL


def test_solver_family_cross_consistency():
    """Jacobi, CG and MG converge to the same solution of one system (the
    JAX package's test of the same name, on the port)."""
    rng = np.random.default_rng(5)
    x_true = torch.from_numpy(rng.random((33, 31)).astype(np.float32))
    mass, diff = 1.0, 0.5
    rhs = mass * x_true - dt.fv_laplace(x_true, dim=2, diffusion_coeff=diff)
    sols = [
        solver(torch.zeros_like(x_true), rhs).numpy()
        for solver in (
            dt.Jacobi(maxiter=4000, mass_coeff=mass, diffusion_coeff=diff),
            dt.CG(maxiter=400, tol=1e-12, mass_coeff=mass, diffusion_coeff=diff),
            dt.MG(maxiter=60, tol=1e-12, mass_coeff=mass, diffusion_coeff=diff),
        )
    ]
    assert np.allclose(sols[0], sols[1], atol=5e-4)
    assert np.allclose(sols[1], sols[2], atol=5e-4)
    assert np.allclose(sols[1], x_true.numpy(), atol=5e-4)


def test_mg_level_wise_surface_against_jax():
    x, mass, diff = _fields((37, 50), seed=11)
    mj = da.MG(depth=2, smoother_iterations=2, mass_coeff=mass, diffusion_coeff=diff)
    mt = dt.MG(depth=2, smoother_iterations=2, mass_coeff=mass, diffusion_coeff=diff)
    xt = torch.from_numpy(x)
    assert np.abs(mt.operator(xt, 0.5).numpy() - np.asarray(mj.operator(x, 0.5))).max() <= 1e-5
    coarse = mt.restriction(xt)
    assert np.array_equal(coarse.numpy(), np.asarray(mj.restriction(x)))
    assert np.array_equal(
        mt.prolongation(coarse, (37, 50)).numpy(),
        np.asarray(mj.prolongation(np.asarray(coarse), (37, 50))),
    )
    assert tuple(mt.prolongation(coarse).shape) == (36, 50)
    cycle = mt.base_V_Cycle(xt, torch.from_numpy(mass * x)).numpy()
    assert np.abs(cycle - np.asarray(mj.base_V_Cycle(x, mass * x))).max() <= SWEEP_TOL
    # Coefficients one level down and back.
    mt.restrict_parameters()
    mj.restrict_parameters()
    assert tuple(mt.mass_coeff.shape) == (18, 25)
    # A numpy field stays on the host until a solve takes it to the data.
    assert isinstance(mt.diffusion_coeff, np.ndarray)
    assert np.array_equal(mt.diffusion_coeff, np.asarray(mj.diffusion_coeff))
    coarse_x = mt.restriction(xt)
    assert np.abs(
        mt.operator(coarse_x).numpy() - np.asarray(mj.operator(np.asarray(coarse_x)))
    ).max() <= 1e-5
    mt.prolongate_parameters()
    assert mt.mass_coeff is mass
    # A tensor field is coarsened on its device.
    on_device = dt.MG(mass_coeff=torch.from_numpy(mass), diffusion_coeff=0.5)
    on_device.restrict_parameters()
    assert torch.equal(on_device.mass_coeff, mt.restriction(torch.from_numpy(mass)))
    assert on_device.diffusion_coeff == 0.5
    with pytest.raises(RuntimeError):
        mt.prolongate_parameters()


def test_solver_classes_take_numpy_fields_to_the_data():
    x, mass, diff = _fields((20, 24), seed=12)
    xt = torch.from_numpy(x)
    for cls, kw in ((dt.Jacobi, {"maxiter": 3}), (dt.CG, {"maxiter": 3}), (dt.MG, {"maxiter": 1})):
        from_numpy = cls(mass_coeff=mass, diffusion_coeff=diff, **kw)(xt, xt)
        from_tensor = cls(
            mass_coeff=torch.from_numpy(mass), diffusion_coeff=torch.from_numpy(diff), **kw
        )(xt, xt)
        assert torch.equal(from_numpy, from_tensor)
    plain = dt.Solver()
    plain.update_params(dim=3, mass_coeff=2.0)
    assert (plain.dim, plain.mass_coeff, plain.diffusion_coeff) == (3, 2.0, None)
    with pytest.raises(NotImplementedError):
        plain(xt, xt)


# ------------------------------------------- stopping rules on the device


def test_iterate_while_freezes_the_state_at_the_stopping_iteration():
    """The result is bitwise what leaving the loop at the first failed test
    gives, and the count says where that was."""

    def cond(state, it):
        return state[0].sum() < 10.0

    def body(state, it):
        return (state[0] + 1.5, state[1] * 2.0)

    start = (torch.zeros(3), torch.ones(2))
    x, y = start
    steps = 0
    while steps < 50 and x.sum() < 10.0:
        x, y = x + 1.5, y * 2.0
        steps += 1
    (gx, gy), taken = tsolvers.iterate_while(cond, body, start, 50)
    assert torch.equal(gx, x) and torch.equal(gy, y) and taken == steps
    # A loop that starts later counts from there.
    (gx, _), taken = tsolvers.iterate_while(cond, body, start, 50, start=4)
    assert torch.equal(gx, x) and taken == steps + 4
    # The cap ends the loop where the test never fails.
    (gx, _), taken = tsolvers.iterate_while(cond, body, start, 2)
    assert torch.equal(gx, torch.full((3,), 3.0)) and taken == 2


def test_flag_reads_follow_the_cadence(monkeypatch):
    """The flag is read once per iteration and once more where the loop
    stops: a loop that stops after 3 iterations reads it 4 times, one that
    runs into its cap of 20 reads it 20 times, and a plain bool costs no
    read."""

    def body(state, it):
        return (state[0] + 1.0,)

    reads = record_host_reads(monkeypatch)
    tsolvers.iterate_while(lambda s, it: s[0].sum() < 3.0, body, (torch.zeros(1),), 20)
    assert reads == [("__bool__", ())] * 4
    del reads[:]
    tsolvers.iterate_while(lambda s, it: s[0].sum() < 99.0, body, (torch.zeros(1),), 20)
    assert reads == [("__bool__", ())] * 20
    del reads[:]
    tsolvers.iterate_while(lambda s, it: True, body, (torch.zeros(1),), 5)
    assert reads == []


@pytest.mark.parametrize("solver", ["jacobi", "mg"])
def test_fixed_count_solvers_read_nothing_to_the_host(monkeypatch, solver):
    x, mass, diff = _fields((20, 24), seed=13)
    xt, mt, dtt = torch.from_numpy(x), torch.from_numpy(mass), torch.from_numpy(diff)
    run = {
        "jacobi": lambda: dt.Jacobi(maxiter=4, mass_coeff=mt, diffusion_coeff=dtt)(xt, mt * xt),
        "mg": lambda: dt.MG(maxiter=2, depth=2, mass_coeff=mt, diffusion_coeff=dtt)(xt, mt * xt),
    }[solver]
    reads = record_host_reads(monkeypatch)
    out = run()
    monkeypatch.undo()
    assert reads == []
    assert torch.isfinite(out).all()
