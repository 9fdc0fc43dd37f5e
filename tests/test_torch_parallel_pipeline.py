"""The sharded production pipeline, the sharded TPFA CG and the batch-sharded
W1 against the JAX package, on the CPU.

Meshes of ``cpu`` x 8 (x 4) in the port, the 8-device virtual CPU mesh of
``tests/conftest.py`` in the JAX package; the same seeded numpy inputs at the
shapes and tolerances of ``tests/unit/test_parallel.py``: the pipeline's
concentration within max 2e-3 / mean 1e-5 (one uint8 step through the model
bounds the max: tile-local warp coordinates may flip a rounding), the TPFA
pressure within 1e-4 of its scale (with a residual below 1e-3), the W1
distances within 2e-3.  Each sharded result is also held against the port's
own unsharded path: the public ``FusedAnalysisPipeline`` and analysis,
``tpfa_cg``, ``batched_wasserstein`` (within 1e-4, the gate of the JAX
package's multi-device dry run).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu.parallel as jpar
import darsia_tpu_torch as dt
from darsia_tpu.corrections.fuse import fused_chain as jax_fused_chain
from darsia_tpu.measure.beckmann_kernels import tpfa_apply as jax_tpfa_apply
from darsia_tpu.restoration.averaging import uniform_filter
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.corrections.fuse import fused_chain
from darsia_tpu_torch.measure.beckmann_kernels import tpfa_cg
from darsia_tpu_torch.parallel import (
    batched_wasserstein,
    create_mesh,
    sharded_production_pipeline,
    sharded_tpfa_cg,
    sharded_wasserstein_batch,
)
from darsia_tpu_torch.utils.linear_solvers import Jacobi

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
PIPE_MAX, PIPE_MEAN = 2e-3, 1e-5


def _require_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs the 8-device CPU mesh.")


def _analysis(pkg, base_img, restoration):
    """The same ConcentrationAnalysis in either package (``pkg`` is the
    module, ``Jacobi`` its solver class)."""
    jacobi = JaxJacobi if pkg is da else Jacobi
    mu, omega, maxiter = (restoration[k] for k in ("mu", "omega", "maxiter"))
    return pkg.ConcentrationAnalysis(
        base=base_img,
        signal_reduction=pkg.MonochromaticReduction(color="gray"),
        restoration=lambda s: pkg.H1_regularization(
            s, mu=mu, omega=omega, dim=2, solver=jacobi(maxiter=maxiter)
        ),
        model=pkg.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )


def _corrections(pkg, translation, bulge):
    return [
        pkg.TranslationCorrection(translation),
        pkg.CurvatureCorrection(config={"bulge": bulge}),
    ]


PLAIN_BULGE = {"horizontal_bulge": -2e-7, "vertical_bulge": -4e-6, "vertical_center_offset": -3}
PLAIN_REST = {"mu": 1.0, "omega": 0.2, "maxiter": 10}


def _plain_frames(B):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
    return base, np.stack([np.roll(base, shift=(2 + k, 3), axis=(0, 1)) for k in range(B)])


@functools.lru_cache(maxsize=None)
def _jax_plain(mesh_shape):
    mesh = jpar.create_mesh(mesh_shape, ("batch", "space"))
    base_u8, frames = _plain_frames(2 * mesh_shape[0])
    chain = _corrections(da, [2.0, -3.0], PLAIN_BULGE)
    base_img = da.OpticalImage(base_u8, transformations=chain, width=2.8, height=1.5).img_as(
        np.float32
    )
    analysis = _analysis(da, base_img, PLAIN_REST)
    step = jpar.sharded_production_pipeline(
        mesh, jax_fused_chain(chain, (128, 128)), analysis, (128, 128), PLAIN_REST
    )
    return np.array(step(jnp.asarray(frames), jnp.asarray(base_img.img)))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_sharded_production_pipeline_matches_public_path(mesh_shape):
    """The fused correction chain + ConcentrationAnalysis's own stages,
    batch x space sharded, == the JAX package's sharded program and == the
    port's public per-frame path."""
    _require_mesh()
    jax_out = _jax_plain(mesh_shape)
    mesh = create_mesh(mesh_shape, ("batch", "space"), devices=CPU8)
    B = 2 * mesh_shape[0]
    base_u8, frames = _plain_frames(B)
    chain = _corrections(dt, [2.0, -3.0], PLAIN_BULGE)
    meta = {"width": 2.8, "height": 1.5}
    base_img = dt.OpticalImage(torch.from_numpy(base_u8), transformations=chain, **meta).img_as(
        np.float32
    )
    analysis = _analysis(dt, base_img, PLAIN_REST)
    step = sharded_production_pipeline(
        mesh, fused_chain(chain, (128, 128), "cpu"), analysis, (128, 128), PLAIN_REST
    )
    out = step(torch.from_numpy(frames), base_img.img)
    assert out.shape == (B, 128, 128)
    for k in range(B):
        img = dt.OpticalImage(torch.from_numpy(frames[k]), transformations=chain, **meta)
        expected = analysis(img.img_as(np.float32)).img
        for ref in (expected, torch.from_numpy(jax_out[k])):
            diff = (out[k] - ref).abs()
            assert float(diff.max()) <= PIPE_MAX
            assert float(diff.mean()) <= PIPE_MEAN


REG_BULGE = {"horizontal_bulge": -2e-7, "vertical_bulge": -4e-6}
REG_REST = {"mu": 1.0, "omega": 0.2, "maxiter": 5}


def _smooth_frames(H):
    """Smoothed random colour layers (as the JAX test makes them) and two
    rolled frames."""
    W = 256
    rng = np.random.default_rng(11)
    layers = []
    for _ in range(3):
        smooth = np.asarray(uniform_filter(jnp.asarray(rng.random((H, W), np.float32)), 7))
        layers.append((smooth - smooth.min()) / (smooth.max() - smooth.min()))
    base = (np.stack(layers, axis=-1) * 255).astype(np.uint8)
    return base, np.stack([np.roll(base, shift=(1 + k, 2), axis=(0, 1)) for k in range(2)])


@functools.lru_cache(maxsize=None)
def _jax_registered(H):
    mesh = jpar.create_mesh((2, 4), ("batch", "space"))
    base_u8, frames = _smooth_frames(H)
    chain = _corrections(da, [1.0, -2.0], REG_BULGE)
    base_img = da.OpticalImage(base_u8, transformations=chain, width=1.0, height=1.0).img_as(
        np.float32
    )
    registration = da.ImageRegistration(base_img, N_patches=[2, 4], rel_overlap=0.2, quality_tol=0.01)
    step = jpar.sharded_production_pipeline(
        mesh,
        jax_fused_chain(chain, (H, 256)),
        _analysis(da, base_img, REG_REST),
        (H, 256),
        REG_REST,
        registration=registration,
        max_disp=16,
    )
    return np.array(step(jnp.asarray(frames), jnp.asarray(base_img.img)))


@pytest.mark.parametrize("H", [186, 192])
def test_sharded_production_pipeline_with_registration(H):
    """correct + fused registration + concentrate, sharded batch x space,
    with a row count that does not tile the space axis (186: pad-to-tile),
    == the JAX package's sharded program and == FusedAnalysisPipeline."""
    _require_mesh()
    jax_out = _jax_registered(H)
    mesh = create_mesh((2, 4), ("batch", "space"), devices=CPU8)
    base_u8, frames = _smooth_frames(H)
    chain = _corrections(dt, [1.0, -2.0], REG_BULGE)
    meta = {"width": 1.0, "height": 1.0}
    base_img = dt.OpticalImage(torch.from_numpy(base_u8), transformations=chain, **meta).img_as(
        np.float32
    )
    analysis = _analysis(dt, base_img, REG_REST)
    registration = dt.ImageRegistration(base_img, N_patches=[2, 4], rel_overlap=0.2, quality_tol=0.01)
    step = sharded_production_pipeline(
        mesh,
        fused_chain(chain, (H, 256), "cpu"),
        analysis,
        (H, 256),
        REG_REST,
        registration=registration,
        max_disp=16,
    )
    out = step(torch.from_numpy(frames), base_img.img)
    assert out.shape == (2, H, 256)
    pipe = dt.FusedAnalysisPipeline(
        transformations=chain, registration=registration, analysis=analysis, max_disp=16
    )
    for k in range(2):
        expected = pipe(dt.OpticalImage(torch.from_numpy(frames[k]), **meta)).img
        for ref in (expected, torch.from_numpy(jax_out[k])):
            diff = (out[k] - ref).abs()
            assert float(diff.max()) <= PIPE_MAX, float(diff.max())
            assert float(diff.mean()) <= PIPE_MEAN, float(diff.mean())


def test_sharded_tpfa_cg_matches_single_device():
    _require_mesh()
    H, W = 64, 48
    rng = np.random.default_rng(0)
    tr = rng.uniform(0.5, 2.0, (H - 1, W)).astype(np.float32)
    tc = rng.uniform(0.5, 2.0, (H, W - 1)).astype(np.float32)
    rhs = rng.standard_normal((H, W)).astype(np.float32)
    rhs -= rhs.mean()
    jax_mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(8), ("space",))
    jax_p = np.asarray(
        jpar.sharded_tpfa_cg(jax_mesh, (H, W), tol=1e-8, maxiter=3000)(
            jnp.asarray(tr), jnp.asarray(tc), jnp.asarray(rhs)
        )
    )
    mesh = create_mesh((8,), ("space",), devices=CPU8)
    out = sharded_tpfa_cg(mesh, (H, W), tol=1e-8, maxiter=3000)(tr, tc, rhs).numpy()
    single = tpfa_cg(
        (torch.from_numpy(tr), torch.from_numpy(tc)),
        torch.from_numpy(rhs),
        torch.zeros(H, W),
        dim=2,
        tol=1e-8,
        maxiter=3000,
    ).numpy()

    b = out - out.mean()
    for ref in (jax_p, single):
        a = ref - ref.mean()
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-30)
    residual = np.asarray(jax_tpfa_apply(jnp.asarray(b), (jnp.asarray(tr), jnp.asarray(tc)), 2)) - rhs
    assert np.abs(residual).max() < 1e-3


def _w1_pairs(B):
    n = 10
    srcs, dsts = [], []
    for seed in range(B):
        rng = np.random.default_rng(seed)
        src = np.zeros((n, n))
        src[2:5, 2:5] = 1
        dst = np.zeros((n, n))
        dst[1:3, 1:2] = 1
        dst[4:7, 7:9] = 1
        src = src + 0.02 * rng.random((n, n))
        dst = dst + 0.02 * rng.random((n, n))
        srcs.append(src / (src.sum() * 0.01))
        dsts.append(dst / (dst.sum() * 0.01))
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


W1_OPTIONS = {"num_iter": 200, "tol_distance": 1e-5}


@pytest.mark.parametrize("mesh_size", [4, 8])
def test_sharded_wasserstein_batch_matches_per_item(mesh_size):
    """Batch-sharded W1 (each mesh position solves its own pairs) == the JAX
    package's batch-sharded distances (4 positions) and == the port's
    unsharded batched solve (8 positions), all pairs converged."""
    _require_mesh()
    srcs, dsts = _w1_pairs(mesh_size)
    mesh = create_mesh((mesh_size,), ("batch",), devices=["cpu"] * mesh_size)
    solve = sharded_wasserstein_batch(mesh, (10, 10), voxel_size=0.1, options=W1_OPTIONS)
    dist, iters, status = solve(torch.from_numpy(srcs), torch.from_numpy(dsts))
    assert dist.shape == iters.shape == status.shape == (mesh_size,)
    assert (status == 1).all()
    if mesh_size == 4:
        jax_mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("batch",))
        jax_dist, _, jax_status = jpar.sharded_wasserstein_batch(
            jax_mesh, (10, 10), voxel_size=0.1, options=W1_OPTIONS
        )(srcs, dsts)
        assert (np.asarray(jax_status) == 1).all()
        assert np.abs(dist - np.asarray(jax_dist)).max() < 2e-3
    else:
        ref, _, _ = batched_wasserstein((10, 10), voxel_size=0.1, options=W1_OPTIONS)(
            torch.from_numpy(srcs), torch.from_numpy(dsts)
        )
        assert np.abs(dist - ref).max() <= 1e-4
