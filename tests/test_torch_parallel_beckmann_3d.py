"""The spatially sharded W1 Newton solve in 3-D, its fluxes and the
``wasserstein_distance`` facade, against the JAX package, on the CPU.

Meshes of ``cpu`` x 8 in the port; the shapes and tolerances of
``tests/unit/test_parallel.py`` (distances within rtol 1e-3, the fluxes'
mass balance within 5e-3).  The 3-D solve and the facade are held against the
JAX package's sharded solve and against the port's single-device
``BeckmannNewtonSolver`` (which ``tests/test_torch_beckmann.py`` holds
against the JAX package); the fluxes against the JAX package's face
divergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import darsia_tpu as da
import darsia_tpu.parallel as jpar
import darsia_tpu_torch as dt
from darsia_tpu.measure import beckmann_kernels as jax_bk
from darsia_tpu_torch.parallel import create_mesh, sharded_beckmann_newton

torch.set_num_threads(1)

MESH = create_mesh((8,), ("space",), devices=["cpu"] * 8)


def _require_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs the 8-device CPU mesh.")


def _single(shape, mass_diff, **options):
    """The port's single-device Newton distance at the sharded solve's
    modes (cell-based mobility, constant cell projection)."""
    solver = dt.BeckmannNewtonSolver(
        dt.Grid(shape, 1.0 / shape[0]),
        options={
            "mobility_mode": dt.MobilityMode("cell_based"),
            "l1_mode": dt.L1Mode("constant_cell_projection"),
            "L": 1e9,
            **options,
        },
    )
    return float(solver.solve_beckmann_problem(torch.from_numpy(mass_diff))[0])


def test_sharded_beckmann_newton_3d_matches_single_device():
    """3-D slab decomposition: sharded == single-device distance."""
    _require_mesh()
    n = 16
    src = np.zeros((n, n, n))
    src[3:7, 3:7, 3:7] = 1
    dst = np.zeros((n, n, n))
    dst[9:14, 10:15, 8:13] = 1
    mass_diff = (dst / dst.sum() * n**3 - src / src.sum() * n**3).astype(np.float32)
    options = {"num_iter": 300, "tol_increment": 1e-5, "tol_distance": 1e-5, "aa_depth": 5}
    distance, pressure, iterations = sharded_beckmann_newton(
        MESH, (n, n, n), voxel_size=1.0 / n, **options
    )(mass_diff)
    assert pressure.shape == (n, n, n)
    assert iterations > 1
    jax_distance, _, _ = jpar.sharded_beckmann_newton(
        JaxMesh(np.array(jax.devices()[:8]), ("space",)), (n, n, n), voxel_size=1.0 / n, **options
    )(mass_diff)
    assert np.isclose(float(distance), float(jax_distance), rtol=1e-3)
    assert np.isclose(float(distance), _single((n, n, n), mass_diff, **options), rtol=1e-3)


def test_sharded_beckmann_newton_returns_fluxes():
    """``return_fluxes=True``: per-axis face arrays in the single-device
    layout that satisfy the discrete mass balance (the JAX package's face
    divergence of the port's fluxes)."""
    _require_mesh()
    n = 32
    src = np.zeros((n, n))
    src[6:14, 6:14] = 1
    dst = np.zeros((n, n))
    dst[18:28, 20:30] = 1
    mass_diff = (dst / dst.sum() * n * n - src / src.sum() * n * n).astype(np.float32)
    options = {"num_iter": 300, "tol_increment": 1e-5, "tol_distance": 1e-5, "aa_depth": 5}
    solve = sharded_beckmann_newton(MESH, (n, n), voxel_size=1.0 / n, **options)
    distance, fluxes, _, _ = solve(mass_diff, return_fluxes=True)
    assert fluxes[0].shape == (n - 1, n)
    assert fluxes[1].shape == (n, n - 1)
    div = np.asarray(
        jax_bk.face_divergence(tuple(jnp.asarray(f.numpy()) for f in fluxes), (1.0 / n, 1.0 / n), 2)
    )
    rhs = (1.0 / n) ** 2 * mass_diff
    assert np.linalg.norm(div - rhs) < 5e-3 * np.linalg.norm(rhs)
    # The default return is unchanged.
    d2, _, _ = solve(mass_diff)
    assert float(d2) == float(distance)
    assert np.isclose(float(distance), _single((n, n), mass_diff, **options), rtol=1e-3)


def test_wasserstein_facade_sharded_newton():
    """``wasserstein_distance(method="sharded_newton")`` == the JAX package's
    facade on its mesh, and == the port's single-device Newton."""
    _require_mesh()
    n = 16
    src = np.zeros((n, n))
    src[3:7, 3:7] = 1
    dst = np.zeros((n, n))
    dst[9:14, 10:15] = 1
    src, dst = src / src.sum() * n * n, dst / dst.sum() * n * n
    options = {"num_iter": 200, "tol_increment": 1e-5, "tol_distance": 1e-5, "aa_depth": 5}
    jax_distance = da.wasserstein_distance(
        da.Image(src, width=1.0, height=1.0, scalar=True),
        da.Image(dst, width=1.0, height=1.0, scalar=True),
        method="sharded_newton",
        options={"mesh": JaxMesh(np.array(jax.devices()[:8]), ("space",)), **options},
    )
    meta = {"width": 1.0, "height": 1.0, "scalar": True}
    src_img = dt.Image(torch.from_numpy(src), **meta)
    dst_img = dt.Image(torch.from_numpy(dst), **meta)
    distance, info = dt.wasserstein_distance(
        src_img,
        dst_img,
        method="sharded_newton",
        options={"mesh": MESH, "return_info": True, **options},
    )
    reference = dt.wasserstein_distance(
        src_img,
        dst_img,
        method="newton",
        options={
            "num_iter": 200,
            "tol_increment": 1e-5,
            "tol_distance": 1e-5,
            "mobility_mode": dt.MobilityMode("cell_based"),
            "l1_mode": dt.L1Mode("constant_cell_projection"),
            "L": 1e9,
        },
    )
    assert np.isclose(distance, float(jax_distance), rtol=1e-3)
    assert np.isclose(distance, float(reference), rtol=1e-3)
    assert info["number_iterations"] > 1
    assert info["pressure"].shape == (n, n)
