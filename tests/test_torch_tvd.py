"""The port's total-variation denoising against the JAX package, on the CPU.

Same numpy inputs (made from a seed) to both packages.  Tolerances on
unit-range float32 images: fixed-count runs (``eps=None``) are the same
float32 arithmetic, held to 2e-6 (5e-6 where CG's reductions sit inside);
runs with a stopping rule compare the solution to 1e-5 (the energy and norm
reductions sum in another order in the two libraries, so a run may stop an
iteration apart) and do not compare iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_solvers import record_host_reads

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.ops.tv import chambolle_tvd as jax_chambolle
from darsia_tpu_torch.ops.tv import _chambolle
from darsia_tpu_torch.restoration.split_bregman_tvd import _bregman

torch.set_num_threads(1)

FIXED_TOL = 2e-6
CG_TOL = 5e-6
LOOP_TOL = 1e-5


def _blocks(shape, seed=0, noise=0.1):
    """Block structure plus noise, as the JAX package's bench builds its
    TVD image."""
    rng = np.random.default_rng(seed)
    coarse = rng.random(tuple(-(-n // 8) for n in shape))
    img = np.kron(coarse, np.ones((8,) * len(shape)))[tuple(slice(0, n) for n in shape)]
    return np.clip(img + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)


def _solver_pair(name):
    kw = {
        "Jacobi": {"maxiter": 6},
        "CG": {"maxiter": 6},
        "MG": {"maxiter": 2, "depth": 2, "smoother_iterations": 2},
    }[name]
    return getattr(da, name)(**kw), getattr(dt, name)(**kw)


def _rof_energy(u, f, weight):
    """The ROF energy Chambolle's method descends, in numpy float64."""
    u, f = u.astype(np.float64), f.astype(np.float64)
    grads = [np.diff(u, axis=ax, append=np.take(u, [-1], axis=ax)) for ax in range(u.ndim)]
    return 0.5 * ((u - f) ** 2).sum() + weight * np.sqrt(sum(g**2 for g in grads)).sum()


# ---------------------------------------------------------------- Chambolle


@pytest.mark.parametrize("shape", [(48, 64), (37, 50), (12, 16, 20), (40,)], ids=str)
def test_chambolle_against_jax(shape):
    img = _blocks(shape)
    for weight, eps, cap in ((0.1, 2e-4, 200), (0.3, 1e-3, 200), (0.2, 0.0, 12)):
        want = np.asarray(jax_chambolle(jnp.asarray(img), weight=weight, eps=eps, max_num_iter=cap))
        got = dt.chambolle_tvd(torch.from_numpy(img), weight=weight, eps=eps, max_num_iter=cap)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.abs(got.numpy() - want).max() <= (FIXED_TOL if eps == 0.0 else LOOP_TOL)


def test_chambolle_lowers_the_rof_energy_and_stops_early():
    img = _blocks((48, 64), seed=1)
    out, taken = _chambolle(torch.from_numpy(img), 0.15, 2e-4, 200)
    assert 2 < int(taken) < 200
    assert _rof_energy(out.numpy(), img, 0.15) < _rof_energy(img, img, 0.15)


def test_chambolle_result_does_not_depend_on_the_flag_cadence():
    """The stop flag is read every iteration, so the result is bitwise the
    fixed-count run (``eps=0`` never stops) of as many iterations."""
    img = torch.from_numpy(_blocks((37, 50), seed=2))
    reference, steps = _chambolle(img, 0.2, 1e-3, 200)
    assert 2 < steps < 200
    fixed, taken = _chambolle(img, 0.2, 0.0, steps)
    assert torch.equal(fixed, reference) and taken == steps


# ------------------------------------------------------------ split-Bregman


@pytest.mark.parametrize("solver", ["Jacobi", "CG", "MG"])
@pytest.mark.parametrize("eps", [None, 1e-3], ids=["fixed", "eps"])
@pytest.mark.parametrize("isotropic", [False, True], ids=["anisotropic", "isotropic"])
def test_split_bregman_against_jax(isotropic, eps, solver):
    img = _blocks((37, 50), seed=3)
    sj, st = _solver_pair(solver)
    kw = {"mu": 0.3, "max_num_iter": 8, "eps": eps, "isotropic": isotropic}
    want = np.asarray(da.split_bregman_tvd(jnp.asarray(img), solver=sj, **kw))
    got = dt.split_bregman_tvd(torch.from_numpy(img), solver=st, **kw).numpy()
    tol = LOOP_TOL if eps is not None else CG_TOL if solver == "CG" else FIXED_TOL
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("isotropic", [False, True], ids=["anisotropic", "isotropic"])
@pytest.mark.parametrize("which", ["mu", "omega", "ell", "all"])
def test_split_bregman_field_weights_against_jax(which, isotropic):
    img = _blocks((40, 48), seed=4)
    rng = np.random.default_rng(5)
    fields = {
        "mu": (0.1 + 0.4 * rng.random(img.shape)).astype(np.float32),
        "omega": (0.5 + rng.random(img.shape)).astype(np.float32),
        "ell": (0.5 + rng.random(img.shape)).astype(np.float32),
    }
    chosen = fields if which == "all" else {which: fields[which]}
    kw = {"mu": 0.3, "omega": 1.0, **{k: v for k, v in chosen.items()}}
    common = {"max_num_iter": 6, "isotropic": isotropic}
    want = np.asarray(
        da.split_bregman_tvd(
            jnp.asarray(img), **{k: jnp.asarray(v) if k in chosen else v for k, v in kw.items()}, **common
        )
    )
    # Numpy fields go to the image's device; tensors stay.
    got = dt.split_bregman_tvd(torch.from_numpy(img), **kw, **common)
    again = dt.split_bregman_tvd(
        torch.from_numpy(img),
        **{k: torch.from_numpy(v) if k in chosen else v for k, v in kw.items()},
        **common,
    )
    assert torch.equal(got, again)
    assert np.abs(got.numpy() - want).max() <= FIXED_TOL


def test_split_bregman_3d_against_jax():
    vol = _blocks((12, 16, 20), seed=6)
    for solver in ("Jacobi", "MG"):
        sj, st = _solver_pair(solver)
        for isotropic in (False, True):
            kw = {"mu": 0.4, "dim": 3, "max_num_iter": 4, "isotropic": isotropic}
            want = np.asarray(da.split_bregman_tvd(jnp.asarray(vol), solver=sj, **kw))
            got = dt.split_bregman_tvd(torch.from_numpy(vol), solver=st, **kw).numpy()
            assert np.abs(got - want).max() <= FIXED_TOL


def test_split_bregman_warm_start_against_jax():
    """``x0=(image, d, b)`` with d and b of shape (*shape, dim), as the JAX
    package takes them."""
    img = _blocks((37, 50), seed=7)
    rng = np.random.default_rng(8)
    x_start = _blocks((37, 50), seed=9)
    d0 = (0.05 * rng.standard_normal((37, 50, 2))).astype(np.float32)
    b0 = (0.05 * rng.standard_normal((37, 50, 2))).astype(np.float32)
    kw = {"mu": 0.3, "max_num_iter": 5, "isotropic": True}
    want = np.asarray(
        da.split_bregman_tvd(
            jnp.asarray(img), x0=(jnp.asarray(x_start), jnp.asarray(d0), jnp.asarray(b0)), **kw
        )
    )
    got = dt.split_bregman_tvd(
        torch.from_numpy(img),
        x0=(torch.from_numpy(x_start), torch.from_numpy(d0), torch.from_numpy(b0)),
        **kw,
    ).numpy()
    assert np.abs(got - want).max() <= FIXED_TOL


@pytest.mark.parametrize("eps", [None, 1e-3], ids=["fixed", "eps"])
def test_split_bregman_adaptive_schedule_against_jax(eps):
    """``adaptive`` sets ell to 1 / |grad u|_1 (unbounded where the image is
    flat, so the image here is noise), held relative to the result's scale."""
    img = np.random.default_rng(10).random((37, 50)).astype(np.float32)
    kw = {"mu": 0.3, "max_num_iter": 6, "eps": eps, "adaptive": lambda it: it % 2 == 1}
    for solver in ("Jacobi", "MG"):
        sj, st = _solver_pair(solver)
        want = np.asarray(da.split_bregman_tvd(jnp.asarray(img), solver=sj, **kw))
        got = dt.split_bregman_tvd(torch.from_numpy(img), solver=st, **kw).numpy()
        assert np.isfinite(want).all()
        assert np.abs(got - want).max() <= LOOP_TOL * max(1.0, np.abs(want).max())


def test_split_bregman_keeps_the_dtype_and_takes_numpy():
    img = (_blocks((32, 40), seed=11) * 255).astype(np.uint8)
    want = np.asarray(da.split_bregman_tvd(jnp.asarray(img), mu=0.2, max_num_iter=4))
    got = dt.split_bregman_tvd(img, mu=0.2, max_num_iter=4, device="cpu")
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            dt.split_bregman_tvd(img, mu=0.2, max_num_iter=1)


def test_bench_configuration_at_64_against_jax():
    """The configuration of the JAX package's bench row (bench.py:726-731:
    mu = 10, ell = 1, 30 iterations, anisotropic, eps=None), at 64 x 64."""
    n = 64
    rng = np.random.default_rng(0)
    img = np.clip(
        np.kron(rng.random((n // 32, n // 32)), np.ones((32, 32)))
        + 0.1 * rng.standard_normal((n, n)),
        0,
        1,
    ).astype(np.float32)
    kw = {"mu": 10.0, "ell": 1.0, "max_num_iter": 30, "isotropic": False, "eps": None}
    want = np.asarray(da.split_bregman_tvd(jnp.asarray(img), **kw))
    got = dt.split_bregman_tvd(torch.from_numpy(img), **kw).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_hoisted_diagonal_and_pyramids_change_nothing():
    """The operator diagonal and the multigrid pyramids are built once per
    call: bitwise what building them in every inner solve gives."""
    from darsia_tpu_torch.ops import solvers

    img = torch.from_numpy(_blocks((37, 50), seed=12))
    omega = torch.from_numpy((0.5 + np.random.default_rng(13).random((37, 50))).astype(np.float32))
    ell = torch.tensor(0.6)
    d = [torch.zeros_like(img) for _ in range(2)]
    b = [torch.zeros_like(img) for _ in range(2)]
    x = img
    for _ in range(3):  # three outer iterations, everything rebuilt each time
        rhs = omega * img
        for i in range(2):
            rhs = rhs + dt.forward_diff(ell * (b[i] - d[i]), axis=i)
        pyramids = [
            tuple(solvers.build_coefficient_pyramid(c, (37, 50), 2, 3)) for c in (omega, ell)
        ]
        x = solvers.mg_solve(x, rhs, *pyramids, depth=2, smoother_iterations=2, maxiter=2)
        dub = [dt.backward_diff(x, j) + b[j] for j in range(2)]
        d = [(c.abs() - 0.3 / ell).clamp(min=0.0) * torch.sign(c) for c in dub]
        b = [c - dj for c, dj in zip(dub, d)]
    got = dt.split_bregman_tvd(
        img, mu=0.3, omega=omega, ell=0.6, max_num_iter=3,
        solver=dt.MG(maxiter=2, depth=2, smoother_iterations=2),
    )
    assert torch.equal(got, x)


# -------------------------------------------------------- stopping rules


@pytest.mark.parametrize("solver", ["Jacobi", "MG"])
@pytest.mark.parametrize("isotropic", [False, True], ids=["anisotropic", "isotropic"])
def test_eps_free_paths_read_nothing_to_the_host(monkeypatch, isotropic, solver):
    img = torch.from_numpy(_blocks((32, 40), seed=14))
    field = torch.from_numpy((0.5 + np.random.default_rng(15).random((32, 40))).astype(np.float32))
    st = _solver_pair(solver)[1]
    reads = record_host_reads(monkeypatch)
    out = dt.split_bregman_tvd(
        img, mu=0.3, omega=field, max_num_iter=5, eps=None, isotropic=isotropic, solver=st,
        adaptive=lambda it: it == 2,
    )
    monkeypatch.undo()
    assert reads == []
    assert torch.isfinite(out).all()


def test_eps_paths_read_only_the_stop_flag(monkeypatch):
    """With ``eps`` the only host reads are 0-d stop flags, one per iteration
    after the first (Chambolle: after the second)."""
    img = torch.from_numpy(_blocks((32, 40), seed=16))
    reads = record_host_reads(monkeypatch)
    dt.split_bregman_tvd(img, mu=0.3, max_num_iter=20, eps=1e-9)
    dt.chambolle_tvd(img, weight=0.2, eps=0.0, max_num_iter=20)
    monkeypatch.undo()
    assert reads == [("__bool__", ())] * (19 + 18)


def test_split_bregman_result_does_not_depend_on_the_flag_cadence():
    """Stopping at the flagged iteration gives bitwise the fixed-count run of
    that length."""
    img = torch.from_numpy(_blocks((37, 50), seed=17))
    zeros = [torch.zeros_like(img) for _ in range(2)]

    def run(max_num_iter, eps):
        return _bregman(
            img, torch.tensor(0.3), torch.tensor(1.0), torch.tensor(0.6), 2, max_num_iter, eps,
            img, zeros, zeros, True, dt.Jacobi(maxiter=5), (False,) * 60,
        )

    reference, steps = run(60, 2e-3)
    assert 1 < steps < 60
    fixed, _ = run(steps, None)
    assert torch.equal(reference, fixed)


# ------------------------------------------------------------ the front end


@pytest.mark.parametrize(
    "method", ["chambolle", "anisotropic bregman", "isotropic bregman", "heterogeneous bregman"]
)
@pytest.mark.parametrize("key", ["", "restoration "])
def test_tvd_front_end_against_jax(key, method):
    img = _blocks((37, 50), seed=18)
    options = {key + "method": method, key + "weight": 0.2, key + "max_num_iter": 12, key + "eps": 1e-3}
    if method == "heterogeneous bregman":
        omega = (0.5 + np.random.default_rng(19).random(img.shape)).astype(np.float32)
        j = da.TVD(key=key, omega=jnp.asarray(omega), **options)
        t = dt.TVD(key=key, omega=omega, **options)
        assert t.regularization == 1.0 and t.omega is omega
    else:
        j, t = da.TVD(key=key, **options), dt.TVD(key=key, **options)
    assert (t.method, t.weight, t.max_num_iter, t.eps) == (method, 0.2, 12, 1e-3)
    want = np.asarray(j(jnp.asarray(img)))
    got = t(torch.from_numpy(img))
    assert np.abs(got.numpy() - want).max() <= LOOP_TOL
    # Unprefixed options are not read under a prefix.
    if key:
        assert dt.TVD(key=key, method="isotropic bregman").method == "chambolle"


def test_heterogeneous_bregman_refuses_a_regularization_as_in_jax():
    """``regularization`` is read but left among the options that go on to
    ``split_bregman_tvd``, which does not take it (darsia_tpu
    restoration/tvd.py:35 reads with ``get``, :68-76 passes ``**kwargs``):
    only the default ell = 1 can be used.  Mirrored, not repaired."""
    img = _blocks((16, 20), seed=23)
    with pytest.raises(TypeError, match="regularization"):
        da.TVD(method="heterogeneous bregman", regularization=0.7)(jnp.asarray(img))
    with pytest.raises(TypeError, match="regularization"):
        dt.TVD(method="heterogeneous bregman", regularization=0.7)(torch.from_numpy(img))


def test_tvd_front_end_defaults_kwargs_and_errors():
    t = dt.TVD()
    assert (t.method, t.weight, t.max_num_iter, t.eps) == ("chambolle", 0.1, 200, 2e-4)
    img = _blocks((32, 40), seed=20)
    # Further kwargs go on to split_bregman_tvd.
    sj, st = _solver_pair("MG")
    want = np.asarray(
        da.TVD(method="isotropic bregman", max_num_iter=4, eps=None, solver=sj)(jnp.asarray(img))
    )
    got = dt.TVD(method="isotropic bregman", max_num_iter=4, eps=None, solver=st, device="cpu")(img)
    assert np.abs(got.numpy() - want).max() <= FIXED_TOL
    with pytest.raises(ValueError, match="not supported"):
        dt.TVD(method="wavelet")(torch.from_numpy(img))


def test_tvd_on_an_image_against_jax():
    img = (_blocks((37, 50), seed=21) * 255).astype(np.uint8)
    meta = {"width": 2.0, "height": 1.5, "name": "signal"}
    j = da.tvd(da.ScalarImage(jnp.asarray(img), **meta), method="anisotropic bregman", weight=0.3, max_num_iter=5, eps=None)
    source = dt.ScalarImage(torch.from_numpy(img), **meta)
    t = dt.tvd(source, method="anisotropic bregman", weight=0.3, max_num_iter=5, eps=None)
    assert type(t) is dt.ScalarImage and t.img.dtype == torch.uint8 and t.name == "signal"
    assert t.dimensions == [1.5, 2.0] and t.img is not source.img
    assert np.abs(t.img.numpy().astype(int) - np.asarray(j.img).astype(int)).max() <= 1
    vol = _blocks((10, 12, 16), seed=22)
    meta3 = {"space_dim": 3, "dimensions": [0.1, 0.2, 0.3]}
    j3 = da.tvd(da.ScalarImage(jnp.asarray(vol), **meta3), weight=0.2)
    t3 = dt.tvd(dt.ScalarImage(torch.from_numpy(vol), **meta3), weight=0.2)
    assert t3.space_dim == 3 and np.abs(t3.img.numpy() - np.asarray(j3.img)).max() <= LOOP_TOL
