"""The spatially sharded W1 Newton solve against the JAX package, on the CPU.

The port's meshes name ``cpu`` four or eight times; the JAX package's solve
runs on the 8-device virtual CPU mesh of ``tests/conftest.py``.  The same
seeded numpy mass differences at the shapes and tolerances of
``tests/unit/test_parallel.py``: without Anderson mixing the distance within
rtol 1e-4, with it within rtol 1e-3.  The 4-shard solves are held against
the JAX package's sharded solve; the 8-shard ones (the costly cases on the
CPU) against the port's single-device ``BeckmannNewtonSolver``, which
``tests/test_torch_beckmann.py`` holds against the JAX package.  The 3-D,
flux and facade cases are in ``test_torch_parallel_beckmann_3d.py``, the
two-level preconditioner in ``test_torch_parallel_two_level.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import darsia_tpu.parallel as jpar
import darsia_tpu_torch as dt
from darsia_tpu_torch.parallel import create_mesh, sharded_beckmann_newton

torch.set_num_threads(1)

TOLS = {"num_iter": 300, "tol_increment": 1e-5, "tol_distance": 1e-5}


def _require_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs the 8-device CPU mesh.")


def _mesh(n):
    return create_mesh((n,), ("space",), devices=["cpu"] * n)


def _blocks(n=32, sign=1):
    """Two squares on n x n with unit mean mass; ``sign`` 1: src - dst."""
    src = np.zeros((n, n))
    src[6:14, 6:14] = 1
    dst = np.zeros((n, n))
    dst[18:28, 20:30] = 1
    src = src / src.sum() * n * n
    dst = dst / dst.sum() * n * n
    return (sign * (src - dst)).astype(np.float32)


def _single(shape, mass_diff, weight=None, **options):
    """The port's single-device Newton distance at the sharded solve's
    modes (cell-based mobility, constant cell projection)."""
    n = shape[0]
    solver = dt.BeckmannNewtonSolver(
        dt.Grid(shape, 1.0 / n),
        None if weight is None else dt.ScalarImage(torch.from_numpy(weight), width=1.0, height=1.0),
        options={
            "mobility_mode": dt.MobilityMode("cell_based"),
            "l1_mode": dt.L1Mode("constant_cell_projection"),
            "L": 1e9,
            **options,
        },
    )
    return float(solver.solve_beckmann_problem(torch.from_numpy(mass_diff))[0])


@functools.lru_cache(maxsize=None)
def _jax_sharded(num_shards, aa_depth):
    mesh = JaxMesh(np.array(jax.devices()[:num_shards]), ("space",))
    distance, _, k = jpar.sharded_beckmann_newton(
        mesh, (32, 32), voxel_size=1.0 / 32, aa_depth=aa_depth, **TOLS
    )(_blocks())
    return float(distance), int(k)


@pytest.mark.parametrize("num_shards", [4, 8])
def test_sharded_beckmann_newton_matches_single_device(num_shards):
    """The domain-decomposed Newton solve (transport density + mobility
    averaging + PCG + flux update, shard by shard) == the reference
    distance; Anderson mixing converges in fewer iterations to the same
    distance."""
    _require_mesh()
    mass_diff = _blocks()
    solve = sharded_beckmann_newton(_mesh(num_shards), (32, 32), voxel_size=1.0 / 32, **TOLS)
    distance, pressure, iterations = solve(mass_diff)
    assert iterations > 1
    assert pressure.shape == (32, 32)
    assert abs(float(pressure.mean())) < 1e-5  # mean-zero pressure gauge
    aa_distance, _, aa_iterations = sharded_beckmann_newton(
        _mesh(num_shards), (32, 32), voxel_size=1.0 / 32, aa_depth=5, **TOLS
    )(mass_diff)
    assert aa_iterations < iterations
    if num_shards == 4:
        plain_ref, aa_ref = _jax_sharded(4, 0)[0], _jax_sharded(4, 5)[0]
    else:
        plain_ref = aa_ref = _single((32, 32), mass_diff, aa_depth=0, **TOLS)
    assert np.isclose(float(distance), plain_ref, rtol=1e-4)
    assert np.isclose(float(aa_distance), aa_ref, rtol=1e-3)


def test_sharded_beckmann_newton_weighted_metric():
    """Heterogeneous cell weights: sharded == single-device distance."""
    _require_mesh()
    n = 32
    mass_diff = _blocks(n)
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    weight = (1.5 + 0.4 * np.sin(2 * np.pi * xx) * np.cos(np.pi * yy)).astype(np.float32)
    options = {**TOLS, "num_iter": 400}
    distance, _, iterations = sharded_beckmann_newton(
        _mesh(8), (n, n), voxel_size=1.0 / n, aa_depth=5, weight=weight, **options
    )(mass_diff)
    assert iterations > 1
    ref = _single((n, n), mass_diff, weight=weight, aa_depth=5, **options)
    assert np.isclose(float(distance), ref, rtol=1e-3)
