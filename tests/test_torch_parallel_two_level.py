"""The spatially sharded W1 Newton solve with the two-level preconditioner
against the JAX package, on the CPU.

A mesh of ``cpu`` x 8 in the port; the shape and tolerance of
``tests/unit/test_parallel.py`` (128 x 128, distance within rtol 2e-3 of the
JAX package's single-device Newton solve, an inner CG budget of 60 under
which Jacobi caps the Newton loop out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
from darsia_tpu_torch.parallel import create_mesh, sharded_beckmann_newton

torch.set_num_threads(1)

MESH = create_mesh((8,), ("space",), devices=["cpu"] * 8)


def _require_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs the 8-device CPU mesh.")


def test_sharded_beckmann_two_level_preconditioner():
    """With a tight inner-CG budget the gathered coarse-grid correction
    converges where Jacobi-PCG cannot."""
    _require_mesh()
    n = 128
    src = np.zeros((n, n))
    src[8:40, 8:40] = 1
    dst = np.zeros((n, n))
    dst[80:120, 88:124] = 1
    mass_diff = (dst / dst.sum() * n * n - src / src.sum() * n * n).astype(np.float32)
    base = {"num_iter": 200, "tol_increment": 1e-4, "tol_distance": 1e-4, "aa_depth": 5}
    reference = float(
        da.BeckmannNewtonSolver(
            da.Grid((n, n), 1.0 / n),
            options={
                **base,
                "mobility_mode": da.MobilityMode("cell_based"),
                "l1_mode": da.L1Mode("constant_cell_projection"),
                "L": 1e9,
            },
        ).solve_beckmann_problem(jnp.asarray(mass_diff))[0]
    )

    two_level, _, k2 = sharded_beckmann_newton(
        MESH, (n, n), voxel_size=1.0 / n, precond="two_level", cg_maxiter=60, **base
    )(mass_diff)
    assert np.isclose(float(two_level), reference, rtol=2e-3)
    assert k2 < 200  # converged, not capped

    jacobi, _, kj = sharded_beckmann_newton(
        MESH, (n, n), voxel_size=1.0 / n, precond="jacobi", cg_maxiter=60, **base
    )(mass_diff)
    # The same inner budget without the coarse correction: Newton caps out
    # and the distance is visibly off.
    assert kj == 200
    assert not np.isclose(float(jacobi), reference, rtol=2e-3)
    with pytest.warns(UserWarning, match="falling back to Jacobi"):
        sharded_beckmann_newton(MESH, (24, 12), precond="two_level")
