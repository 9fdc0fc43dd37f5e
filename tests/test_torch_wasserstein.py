"""Whole W1 solves and the ``wasserstein_distance`` facade against the JAX package.

The reference's anchor problem (two squares on a 10x10 grid, W1 =
0.379543951823) through every solver and mode the JAX package's tests run,
a weighted 32x32 problem, two cubes in 3-D and a distance matrix: the same
numpy inputs through both packages on the CPU.  Each solve of the port takes
the path (device loop or host loop) the JAX package takes for its options, so
the distances agree within 1e-4 relative (float32 sums in another order),
and each also meets the anchor tolerance of the JAX package's own tests
(1e-2; 5e-2 for G-prox).  The JAX solves are shared through module fixtures.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

TRUE_DISTANCE = 0.379543951823
PARITY = 1e-4


def _anchor():
    src = np.zeros((10, 10))
    src[2:5, 2:5] = 1
    dst = np.zeros((10, 10))
    dst[1:3, 1:2] = 1
    dst[4:7, 7:9] = 1
    # Unit mass (Geometry.integrate: the sum times the voxel area 0.01).
    return (src / (src.sum() / 100)).astype(np.float32), (dst / (dst.sum() / 100)).astype(np.float32)


def _blocks(n):
    """The bench's weighted W1 problem (bench.py:344-362) at n x n."""
    src = np.zeros((n, n))
    dst = np.zeros((n, n))
    q = n // 10
    src[2 * q : 5 * q, 2 * q : 5 * q] = 1.0
    dst[q : 3 * q, q : 2 * q] = 1.0
    dst[4 * q : 7 * q, 7 * q : 9 * q] = 1.0
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    weight = (2.0 + np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy)).astype(np.float32)
    return (
        (src / (src.sum() / n**2)).astype(np.float32),
        (dst / (dst.sum() / n**2)).astype(np.float32),
        weight,
    )


META = {"width": 1, "height": 1, "scalar": True}
OPTIONS = {
    "l1_mode": "constant_cell_projection",
    "mobility_mode": "face_based",
    "num_iter": 400,
    "tol_residual": 1e-3,
    "tol_increment": 1e-3,
    "tol_distance": 1e-3,
    "return_info": True,
}
# The JAX package's tests/unit/test_wasserstein.py cases, with AA(5) added to
# Newton in both mobility modes and to Bregman: (method, options, anchor tol).
# Newton drops tol_residual, which neither package meets in float32 (both run
# to the 400-iteration cap with it).
NEWTON = {key: value for key, value in OPTIONS.items() if key != "tol_residual"}
CASES = {
    "newton-face": ("newton", {**NEWTON, "L": 1e9}, 1e-2),
    "newton-cell": ("newton", {**NEWTON, "L": 1e9, "mobility_mode": "cell_based"}, 1e-2),
    "newton-face-aa": ("newton", {**NEWTON, "L": 1e9, "aa_depth": 5}, 1e-2),
    "newton-cell-aa": (
        "newton",
        {**NEWTON, "L": 1e9, "mobility_mode": "cell_based", "aa_depth": 5},
        1e-2,
    ),
    "bregman": ("bregman", {**OPTIONS, "L": 1.0}, 1e-2),
    "bregman-adaptive": (
        "bregman",
        {**OPTIONS, "L": 1.0, "bregman_update": lambda it: it % 20 == 0},
        1e-2,
    ),
    "bregman-aa": ("bregman", {**OPTIONS, "L": 1.0, "aa_depth": 5}, 1e-2),
    "gprox": (
        "gprox",
        {"l1_mode": "raviart_thomas", "num_iter": 400, "tol_increment": 1e-5,
         "tol_distance": 1e-5, "return_info": True},
        5e-2,
    ),
}


def _jax_images(src, dst, **meta):
    meta = {**META, **meta}
    return da.Image(src, **meta), da.Image(dst, **meta)


def _port_images(src, dst, **meta):
    meta = {**META, **meta}
    return dt.Image(src, device="cpu", **meta), dt.Image(dst, device="cpu", **meta)


@pytest.fixture(scope="module")
def jax_anchor():
    src, dst = _anchor()
    return {
        name: da.wasserstein_distance(*_jax_images(src, dst), method=method, options=options)
        for name, (method, options, _) in CASES.items()
    }


@pytest.fixture(scope="module")
def port_anchor():
    src, dst = _anchor()
    return {
        name: dt.wasserstein_distance(*_port_images(src, dst), method=method, options=options)
        for name, (method, options, _) in CASES.items()
    }


@pytest.mark.parametrize("name", list(CASES))
def test_anchor_against_jax(jax_anchor, port_anchor, name):
    (d_j, info_j), (d_t, info_t) = jax_anchor[name], port_anchor[name]
    assert abs(d_t - d_j) <= PARITY * d_j
    assert np.isclose(d_t, TRUE_DISTANCE, rtol=CASES[name][2])
    assert info_t["converged"] == info_j["converged"]
    assert abs(info_t["duality_gap"] - info_j["duality_gap"]) <= 1e-3
    # The fields stay on the images' device (here the CPU).
    for key in ("flux", "pressure", "transport_density", "mass_diff", "weight"):
        assert info_t[key].device.type == "cpu", key
    assert info_t["flux"].shape == (10, 10, 2) and info_t["pressure"].shape == (10, 10)


@pytest.mark.parametrize("name", ["newton-cell", "newton-face-aa", "bregman", "gprox"])
def test_info_dict_keys_are_the_jax_packages(jax_anchor, port_anchor, name):
    """Device-loop runs (cell-based mobility) and host-loop runs (face-based
    mobility) report the JAX package's keys, history and timing keys."""
    info_j, info_t = jax_anchor[name][1], port_anchor[name][1]
    assert set(info_t) == set(info_j)
    assert set(info_t["timings"]) == set(info_j["timings"])
    assert set(info_t["convergence_history"]) == set(info_j["convergence_history"])
    history = info_t["convergence_history"]
    assert len(history["distance"]) == len(history["duality_gap"]) == len(history["timings"])
    assert info_t["peak_memory_consumption"] == 0.0  # no card memory on the CPU


def test_weighted_newton_against_jax():
    """The bench's weighted problem at 32 x 32, Newton with AA(5); the weight
    is a numpy array, which follows the images' device."""
    src, dst, weight = _blocks(32)
    options = {"num_iter": 500, "L": 1e9, "tol_increment": 1e-4, "tol_distance": 1e-4,
               "aa_depth": 5, "return_info": True}
    d_j, info_j = da.wasserstein_distance(
        *_jax_images(src, dst), method="newton",
        weight=da.ScalarImage(weight, width=1, height=1), options=options,
    )
    d_t, info_t = dt.wasserstein_distance(*_port_images(src, dst), method="newton", weight=weight,
                                          options=options)
    assert abs(d_t - d_j) <= PARITY * d_j
    assert info_t["converged"] and info_j["converged"]
    assert info_t["weight"].device.type == "cpu"
    assert torch.equal(info_t["weight"], torch.from_numpy(weight))


def test_3d_two_cubes_against_jax():
    n = 12
    cubes = np.zeros((2, n, n, n), np.float32)
    cubes[0, 2:5, 2:5, 2:5] = 1.0
    cubes[1, 6:9, 6:9, 6:9] = 1.0
    meta = {"dimensions": [1.0, 1.0, 1.0], "scalar": True, "dim": 3}
    options = {"num_iter": 60, "tol_residual": 1e-5}
    d_j = da.wasserstein_distance_3d(*(da.Image(c, **meta) for c in cubes), method="newton",
                                     options=options)
    src, dst = (dt.Image(c, device="cpu", **meta) for c in cubes)
    d_t = dt.wasserstein_distance_3d(src, dst, method="newton", options=options)
    assert abs(d_t - d_j) <= PARITY * d_j
    expected = np.sqrt(3) * 4 / n * 27 / n**3
    assert d_t == pytest.approx(expected, rel=0.03)  # TPFA error at 12^3 (JAX test)


def test_distance_matrix_against_jax():
    src, dst = _anchor()
    mid = np.roll(src, 2, axis=1)
    options = {"num_iter": 100, "tol_increment": 1e-3, "tol_distance": 1e-3, "L": 1e9,
               "return_info": True}
    grid_j, grid_t = da.Grid((10, 10), 0.1), dt.Grid((10, 10), 0.1)
    m_j = da.BeckmannNewtonSolver(grid_j, None, options).distance_matrix(
        [da.Image(a, **META) for a in (src, dst, mid)]
    )
    solver = dt.BeckmannNewtonSolver(grid_t, None, options)
    m_t = solver.distance_matrix([dt.Image(a, device="cpu", **META) for a in (src, dst, mid)])
    assert solver.options["return_info"]  # restored
    assert np.allclose(m_t, m_t.T) and np.all(np.diag(m_t) == 0)
    assert np.abs(m_t - m_j).max() <= PARITY * np.abs(m_j).max()


def test_float64_option_against_float32():
    """The option ``dtype="float64"`` runs in float64 (no global flag); it
    agrees with float32 as in the JAX package's own float64 test (its options
    but tol_residual; there within 1e-5, held to 1e-4 here)."""
    src, dst = _anchor()
    out = {}
    for dtype in ("float32", "float64"):
        options = {"num_iter": 400, "tol_increment": 1e-4, "tol_distance": 1e-4, "L": 1e9,
                   "dtype": dtype, "return_info": True}
        out[dtype] = dt.wasserstein_distance(*_port_images(src, dst), method="newton",
                                             options=options)
    assert out["float64"][1]["pressure"].dtype == torch.float64
    assert out["float32"][1]["pressure"].dtype == torch.float32
    rel = abs(out["float32"][0] - out["float64"][0]) / out["float64"][0]
    assert rel < 1e-4


def test_status_callbacks_and_phase_profile():
    """``return_status``; callbacks and ``verbose`` take the host loop, whose
    result equals the device loop's here; ``profile_phases`` adds measured
    phase seconds to the timings and to every history row."""
    src, dst = _anchor()
    images = _port_images(src, dst)
    options = {"num_iter": 30, "tol_increment": 1e-3, "tol_distance": 1e-3, "L": 1e9}
    d_dev, status = dt.wasserstein_distance(*images, options={**options, "return_status": True})
    assert status is True
    calls = []
    d_host = dt.wasserstein_distance(*images, options={**options, "callbacks": [calls.append]})
    assert len(calls) >= 2 and isinstance(calls[0], dt.BeckmannNewtonSolver)
    assert abs(d_host - d_dev) <= PARITY * d_dev  # float64 against float32 criteria
    for method, phase in (("newton", "mobility"), ("bregman", "shrinkage")):
        _, info = dt.wasserstein_distance(
            *images, method=method,
            options={**options, "return_info": True, "profile_phases": True},
        )
        phases = info["timings"]["phases"]
        assert {"pressure_solve", "flux_update", "metrics", phase} == set(phases)
        assert all(v > 0 for v in phases.values())
        assert info["convergence_history"]["timings"][0]["pressure_solve"] == phases["pressure_solve"]


def test_facade_raises(monkeypatch, tmp_path):
    src, dst = _port_images(*_anchor())
    # "cv2.emd" solves through OpenCV (tests/test_torch_emd.py); where it
    # does not import, the facade names it.
    with monkeypatch.context() as blocked:
        blocked.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError, match="OpenCV"):
            dt.wasserstein_distance(src, dst, method="cv2.emd")
    with pytest.raises(ValueError, match="mesh"):
        dt.wasserstein_distance(src, dst, method="sharded_newton", options={"num_iter": 3})
    with pytest.raises(NotImplementedError, match="not implemented"):
        dt.wasserstein_distance(src, dst, method="sinkhorn")
    with pytest.raises(ValueError, match="3-D"):
        dt.wasserstein_distance_3d(src, dst)
    # An info without fields: both packages' VTK writers index the first.
    for pkg in (da, dt):
        with pytest.raises(IndexError):
            pkg.wasserstein_distance_to_vtk(tmp_path / "out.vtk", {})


def test_sharded_newton_facade_matches_newton():
    """``method="sharded_newton"`` over a mesh of ``cpu`` x 4 on a 16x16 pair
    (the JAX package's facade case): the distance of the single-device
    Newton solve and of the JAX package's facade within rtol 1e-3, and the
    pressure in the single-device sign convention (dst - src)."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    n = 16
    src = np.zeros((n, n))
    src[3:7, 3:7] = 1
    dst = np.zeros((n, n))
    dst[9:14, 10:15] = 1
    src, dst = (src / src.sum() * n * n).astype(np.float32), (dst / dst.sum() * n * n).astype(np.float32)
    tols = {"num_iter": 200, "tol_increment": 1e-5, "tol_distance": 1e-5}
    sharded = {**tols, "aa_depth": 5, "return_info": True}
    newton = {
        **tols,
        "mobility_mode": "cell_based",
        "l1_mode": "constant_cell_projection",
        "L": 1e9,
        "return_info": True,
    }
    images = _port_images(src, dst)
    mesh = dt.parallel.create_mesh((4,), ("space",), devices=["cpu"] * 4)
    distance, info = dt.wasserstein_distance(
        *images, method="sharded_newton", options={"mesh": mesh, **sharded}
    )
    reference, ref_info = dt.wasserstein_distance(*images, method="newton", options=newton)
    jax_distance, _ = da.wasserstein_distance(
        *_jax_images(src, dst),
        method="sharded_newton",
        options={"mesh": JaxMesh(np.array(jax.devices()[:4]), ("space",)), **sharded},
    )
    assert np.isclose(distance, float(reference), rtol=1e-3)
    assert np.isclose(distance, float(jax_distance), rtol=1e-3)
    assert info["number_iterations"] > 1
    p, q = info["pressure"].flatten(), ref_info["pressure"].flatten()
    assert float(torch.dot(p - p.mean(), q - q.mean())) > 0.99 * float((p - p.mean()).norm() * (q - q.mean()).norm())


def test_numpy_mass_without_a_card_raises():
    """A numpy mass difference goes to the card, as every entry point's numpy
    input does; without one that raises and names ``device="cpu"``."""
    solver = dt.BeckmannNewtonSolver(dt.Grid((10, 10), 0.1), None, {"num_iter": 3})
    mass = np.zeros((10, 10), np.float32)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            solver.solve_beckmann_problem(mass)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dt.Image(mass, **META)
    distance, fluxes, pressure, _ = solver.solve_beckmann_problem(torch.from_numpy(mass))
    assert pressure.device.type == "cpu" and distance == 0.0


def test_gprox_on_a_weighted_problem_diverges_as_in_jax():
    """G-prox with its default steps (tau = sigma = 1) blows up on the bench's
    weighted problem in both packages (a reference-side fault): the device
    loop keeps the last finite iterate and stops at the same iteration."""
    src, dst, weight = _blocks(12)
    options = {"num_iter": 300, "tol_residual": 0.0, "tol_increment": 0.0, "tol_distance": 0.0,
               "l1_mode": "raviart_thomas", "return_info": True}
    d_j, info_j = da.wasserstein_distance(
        *_jax_images(src, dst), method="gprox",
        weight=da.ScalarImage(weight, width=1, height=1), options=options,
    )
    d_t, info_t = dt.wasserstein_distance(*_port_images(src, dst), method="gprox", weight=weight,
                                          options=options)
    # The blow-up is exponential: a last-bit difference may move the first
    # non-finite iterate by an iteration.
    assert abs(info_t["number_iterations"] - info_j["number_iterations"]) <= 1
    assert info_t["number_iterations"] < 299 and not info_t["converged"]
    assert d_t > 1e6 * TRUE_DISTANCE and d_j > 1e6 * TRUE_DISTANCE
