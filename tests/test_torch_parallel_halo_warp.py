"""Halo exchanges, the sharded warp and the sharded smoothers against the
JAX package, on the CPU.

The port's meshes name ``cpu`` eight times; the JAX package's run on the
8-device virtual CPU mesh of ``tests/conftest.py``.  The same seeded numpy
inputs go through both, at the shapes and tolerances of
``tests/unit/test_parallel.py``: halos bitwise, the smoothers within rtol
1e-5 / atol 1e-6, the warps within rtol 1e-5 / atol 1e-5.  Each sharded
result is also held, at the same tolerance, against the port's own
unsharded function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import darsia_tpu.parallel as jpar
from darsia_tpu.ops.warp import identity_grid as jax_identity_grid
from darsia_tpu.ops.warp import warp as jax_warp
from darsia_tpu_torch.ops.warp import identity_grid, warp
from darsia_tpu_torch.parallel import (
    Placement,
    create_mesh,
    halo_exchange,
    halo_exchange_2d,
    sharded_analysis_step,
    sharded_tvd,
    sharded_tvd_2d,
    sharded_warp,
)
from darsia_tpu_torch.parallel.pipeline import _local_smooth_sweeps

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
MESH_SHAPES = [(8, 1), (4, 2), (2, 4)]
SMOOTH = {"rtol": 1e-5, "atol": 1e-6}
WARP = {"rtol": 1e-5, "atol": 1e-5}


def _require_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs the 8-device CPU mesh.")


def _jax_mesh(shape, names):
    return jpar.create_mesh(shape, names, devices=jax.devices()[:8])


def test_halo_exchange_matches_padded_single_device():
    """halo_exchange == the edge-replicated pad of the global array, and ==
    the JAX package's exchange, block for block."""
    _require_mesh()
    H, W, halo = 32, 12, 2
    x = np.random.default_rng(3).random((H, W)).astype(np.float32)
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(8), ("space",))
    fn = shard_map(
        lambda local: jpar.halo_exchange(local, halo, "space", axis=0),
        mesh=mesh,
        in_specs=(P("space", None),),
        out_specs=P("space", None),
    )
    jax_out = np.asarray(jax.jit(fn)(jnp.asarray(x)))

    line = Placement(create_mesh((8,), ("space",), devices=CPU8), ("space", None)).split_line(x)
    out = halo_exchange(line, halo, axis=0)
    padded = np.concatenate([np.repeat(x[:1], halo, 0), x, np.repeat(x[-1:], halo, 0)])
    rows = H // 8
    block = rows + 2 * halo
    for s in range(8):
        np.testing.assert_array_equal(out[s].numpy(), padded[s * rows : s * rows + block])
        np.testing.assert_array_equal(out[s].numpy(), jax_out[s * block : (s + 1) * block])


@functools.lru_cache(maxsize=None)
def _tvd_case(mesh_shape):
    B, H, W = 2 * mesh_shape[0], 16 * mesh_shape[1], 24
    batch = np.random.default_rng(7).random((B, H, W)).astype(np.float32)
    mesh = _jax_mesh(mesh_shape, ("batch", "space"))
    placed = jax.device_put(
        jnp.asarray(batch),
        NamedSharding(mesh, P("batch", "space" if mesh_shape[1] > 1 else None, None)),
    )
    return batch, np.asarray(jpar.sharded_tvd(mesh, mu=0.15, iters=6)(placed))


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_tvd_matches_unsharded(mesh_shape):
    _require_mesh()
    batch, jax_out = _tvd_case(mesh_shape)
    mesh = create_mesh(mesh_shape, ("batch", "space"), devices=CPU8)
    out = sharded_tvd(mesh, mu=0.15, iters=6)(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(out, jax_out, **SMOOTH)
    x = torch.from_numpy(batch)
    np.testing.assert_allclose(out, _local_smooth_sweeps(x, x, 0.15, 1.0, 6).numpy(), **SMOOTH)


@functools.lru_cache(maxsize=None)
def _analysis_case(mesh_shape):
    B, H, W = 2 * mesh_shape[0], 16 * mesh_shape[1], 24
    rng = np.random.default_rng(11)
    batch = rng.random((B, H, W, 3)).astype(np.float32)
    base = rng.random((H, W, 3)).astype(np.float32)
    balance = (np.eye(3) * 1.02 + rng.normal(0, 0.01, (3, 3))).astype(np.float32)
    mesh = _jax_mesh(mesh_shape, ("batch", "space"))
    space = "space" if mesh_shape[1] > 1 else None
    step = jpar.sharded_analysis_step(mesh, jnp.asarray(balance), scaling=1.7, tvd_iters=5, mu=0.1)
    out = step(
        jax.device_put(jnp.asarray(batch), NamedSharding(mesh, P("batch", space, None, None))),
        jax.device_put(jnp.asarray(base), NamedSharding(mesh, P(space, None, None))),
    )
    return batch, base, balance, np.asarray(out)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_analysis_step_matches_unsharded(mesh_shape):
    _require_mesh()
    batch, base, balance, jax_out = _analysis_case(mesh_shape)
    mesh = create_mesh(mesh_shape, ("batch", "space"), devices=CPU8)
    step = sharded_analysis_step(mesh, balance, scaling=1.7, tvd_iters=5, mu=0.1)
    out = step(torch.from_numpy(batch), torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(out, jax_out, **SMOOTH)

    m = torch.from_numpy(balance)
    diff = (torch.from_numpy(batch) @ m - (torch.from_numpy(base) @ m)[None]).clamp(min=0)
    signal = diff @ torch.tensor([0.299, 0.587, 0.114])
    ref = 1.7 * _local_smooth_sweeps(signal, signal, 0.1, 1.0, 5)
    np.testing.assert_allclose(out, ref.numpy(), **SMOOTH)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_halo_exchange_2d_corner_correct(mesh_shape):
    """The 2-d exchange delivers the corners from the diagonal neighbours:
    the edge-padded global array, and the JAX package's blocks, bitwise."""
    _require_mesh()
    pr, pc = mesh_shape
    H, W, halo = 8 * pr, 6 * pc, 2
    x = np.random.default_rng(5).random((H, W)).astype(np.float32)
    fn = shard_map(
        lambda local: jpar.halo_exchange_2d(local, halo, "rows", "cols"),
        mesh=_jax_mesh(mesh_shape, ("rows", "cols")),
        in_specs=(P("rows", "cols"),),
        out_specs=P("rows", "cols"),
    )
    jax_out = np.asarray(jax.jit(fn)(jnp.asarray(x)))

    mesh = create_mesh(mesh_shape, ("rows", "cols"), devices=CPU8)
    out = halo_exchange_2d(Placement(mesh, ("rows", "cols")).split(x), halo)
    padded = np.pad(x, halo, mode="edge")
    lh, lw = H // pr, W // pc
    eh, ew = lh + 2 * halo, lw + 2 * halo
    for i in range(pr):
        for j in range(pc):
            block = out[i][j].numpy()
            np.testing.assert_array_equal(block, padded[i * lh : i * lh + eh, j * lw : j * lw + ew])
            np.testing.assert_array_equal(block, jax_out[i * eh : (i + 1) * eh, j * ew : (j + 1) * ew])


def _warp_inputs(mesh_shape, channels):
    pr, pc = mesh_shape
    H, W, D = 16 * pr, 12 * pc, 5
    rng = np.random.default_rng(13)
    img = rng.random((H, W) if channels is None else (H, W, channels)).astype(np.float32)
    # Smooth bounded displacement (|disp| <= D), with samples outside the
    # domain at the boundary (the fill path).
    yy, xx = np.meshgrid(np.linspace(0, np.pi, H), np.linspace(0, np.pi, W), indexing="ij")
    disp = np.stack([D * 0.9 * np.sin(xx), -D * 0.9 * np.cos(yy)]).astype(np.float32)
    return img, disp, D


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("channels", [None, 3])
def test_sharded_warp_matches_single_device(mesh_shape, channels):
    _require_mesh()
    img, disp, D = _warp_inputs(mesh_shape, channels)
    H, W = img.shape[:2]
    mesh_j = _jax_mesh(mesh_shape, ("rows", "cols"))
    coords_j = jax_identity_grid((H, W)) + jnp.asarray(disp)
    space = P("rows", "cols") if channels is None else P("rows", "cols", None)
    jax_out = np.asarray(
        jpar.sharded_warp(mesh_j, (H, W), max_disp=D)(
            jax.device_put(jnp.asarray(img), NamedSharding(mesh_j, space)),
            jax.device_put(coords_j, NamedSharding(mesh_j, P(None, "rows", "cols"))),
        )
    )
    jax_ref = np.asarray(jax_warp(jnp.asarray(img), coords_j, order=1))

    coords = identity_grid((H, W), "cpu") + torch.from_numpy(disp)
    mesh = create_mesh(mesh_shape, ("rows", "cols"), devices=CPU8)
    out = sharded_warp(mesh, (H, W), max_disp=D)(torch.from_numpy(img), coords).numpy()
    np.testing.assert_allclose(out, jax_out, **WARP)
    np.testing.assert_allclose(out, jax_ref, **WARP)
    np.testing.assert_allclose(out, warp(torch.from_numpy(img), coords, order=1).numpy(), **WARP)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_sharded_tvd_2d_matches_unsharded(mesh_shape):
    """The full 2-D decomposition of the smoother == one device."""
    _require_mesh()
    pr, pc = mesh_shape
    H, W = 16 * pr, 12 * pc
    img = np.random.default_rng(17).random((H, W)).astype(np.float32)
    jax_out = np.asarray(
        jpar.sharded_tvd_2d(_jax_mesh(mesh_shape, ("rows", "cols")), mu=0.15, iters=6)(
            jnp.asarray(img)
        )
    )
    mesh = create_mesh(mesh_shape, ("rows", "cols"), devices=CPU8)
    x = torch.from_numpy(img)
    out = sharded_tvd_2d(mesh, mu=0.15, iters=6)(x).numpy()
    np.testing.assert_allclose(out, jax_out, **SMOOTH)
    np.testing.assert_allclose(out, _local_smooth_sweeps(x, x, 0.15, 1.0, 6).numpy(), **SMOOTH)
