"""Stage-level parity of the port with the JAX package, at small shapes.

Covers the trouble spots of the port: the Hann window, bilinear upsampling
of the coarse TPS field (edges included), half-to-even rounding after an
integer warp, argmax ties in phase correlation, and the Jacobi/H1 solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.analysis.translationanalysis import TranslationAnalysis as JaxTA
from darsia_tpu.corrections.shape.quad import quad_coordinate_grid as jax_quad_grid
from darsia_tpu.image.patches import Patches
from darsia_tpu.ops import fft as jfft
from darsia_tpu.ops import solvers as jsolvers
from darsia_tpu.ops.color import rgb_to_gray as jax_rgb_to_gray
from darsia_tpu.utils.dtype import convert_dtype as jax_convert_dtype
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.analysis.translationanalysis import TranslationAnalysis, patch_centers
from darsia_tpu_torch.corrections.shape.quad import quad_coordinate_grid
from darsia_tpu_torch.ops import fft as tfft
from darsia_tpu_torch.ops import solvers as tsolvers
from darsia_tpu_torch.ops.color import rgb_to_gray
from darsia_tpu_torch.utils.dtype import convert_dtype

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2, 17, 64, 256])
def test_hann_window(n):
    ref = np.asarray(jnp.hanning(n)) if n > 1 else np.ones(1)
    out = tfft._hann(n, CPU).numpy()
    # One f32 ulp apart at most.
    assert np.abs(out - ref).max() <= 2.5e-7


@pytest.mark.parametrize("coarse,fine", [((7, 9), (100, 130)), ((4, 5), (61, 77))])
def test_bilinear_upsample_matches_jax_resize(coarse, fine):
    x = np.random.default_rng(1).standard_normal((2,) + coarse).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + fine, method="linear"))
    out = F.interpolate(
        torch.from_numpy(x)[None], size=fine, mode="bilinear", align_corners=False
    )[0].numpy()
    # The interpolation weights are computed differently (scale vs inverse
    # scale): a few f32 ulps of the O(1) samples.
    tol = 4 * np.finfo(np.float32).eps * np.abs(x).max()
    assert np.abs(out - ref).max() <= tol
    # Edges: both hold the outer cell-centre value beyond the outer centres.
    for sl in (np.s_[:, :3], np.s_[:, -3:], np.s_[:, :, :3], np.s_[:, :, -3:]):
        assert np.abs(out[sl] - ref[sl]).max() <= tol


def test_round_half_to_even_after_integer_warp():
    vals = np.array([0.5, 1.5, 2.5, 3.5, 254.5, 2.4999], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(vals)).numpy(), np.asarray(jnp.round(vals)))
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(
        convert_dtype(torch.from_numpy(u8), torch.float32).numpy(),
        np.asarray(jax_convert_dtype(jnp.asarray(u8), np.float32)),
    )
    f = np.linspace(0, 1, 101, dtype=np.float32)
    assert np.array_equal(
        convert_dtype(torch.from_numpy(f), torch.uint8).numpy(),
        np.asarray(jax_convert_dtype(jnp.asarray(f), np.uint8)),
    )


def test_rgb_to_gray():
    x = np.random.default_rng(2).random((13, 17, 3)).astype(np.float32)
    ref = np.asarray(jax_rgb_to_gray(jnp.asarray(x)))
    assert np.abs(rgb_to_gray(torch.from_numpy(x)).numpy() - ref).max() <= 1e-6


def _windows(seed, n=5, shape=(32, 48)):
    rng = np.random.default_rng(seed)
    base = rng.random((n,) + shape).astype(np.float32)
    shifted = np.stack(
        [np.roll(b, (k - 2, 2 * k - 3), axis=(0, 1)) for k, b in enumerate(base)]
    )
    return base, shifted + 0.05 * rng.random(shifted.shape).astype(np.float32)


def test_phase_correlation_prepared():
    base, img = _windows(3)
    shape = base.shape[1:]
    j_spec = jax.vmap(jfft.prepare_phase_reference)(jnp.asarray(base))
    j_shift, j_q = jax.vmap(lambda f, w: jfft.phase_correlation_prepared(f, w, shape))(
        j_spec, jnp.asarray(img)
    )
    t_spec = tfft.prepare_phase_reference(torch.from_numpy(base))
    t_shift, t_q = tfft.phase_correlation_prepared(t_spec, torch.from_numpy(img), shape)
    assert np.abs(t_shift.numpy() - np.asarray(j_shift)).max() <= 1e-3
    assert np.abs(t_q.numpy() - np.asarray(j_q)).max() <= 1e-4


def test_argmax_ties_pick_the_first_peak():
    r = np.zeros((2, 8, 8), np.float32)
    r[:, 2, 5] = r[:, 6, 1] = 1.0  # two equal peaks; the first in row-major order wins
    ref = np.asarray(jnp.argmax(jnp.asarray(r).reshape(2, -1), axis=1))
    out = torch.from_numpy(r).reshape(2, -1).argmax(dim=1).numpy()
    assert np.array_equal(out, ref) and ref[0] == 2 * 8 + 5
    # A constant surface: every entry ties.
    flat = torch.zeros((1, 64)).argmax(dim=1)
    assert int(flat) == int(jnp.argmax(jnp.zeros(64))) == 0


def test_neighbor_accumulation_and_operator_diagonal():
    x = np.random.default_rng(4).random((9, 11)).astype(np.float32)
    ref = np.asarray(jsolvers.neighbor_accumulation(jnp.asarray(x), 2))
    out = tsolvers.neighbor_accumulation(torch.from_numpy(x), 2)
    assert np.abs(out.numpy() - ref).max() <= 1e-6
    dj = np.asarray(jsolvers.operator_diagonal(0.2, 1.0, (9, 11), 2, 1.0))
    dtt = tsolvers.operator_diagonal(0.2, 1.0, (9, 11), 2, 1.0, CPU).numpy()
    assert np.array_equal(dtt, dj)


def test_jacobi_and_h1_regularization():
    x = np.random.default_rng(5).random((24, 30)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref = np.asarray(jsolvers.jacobi_solve(xj, 0.2 * xj, 0.2, 1.0, maxiter=10))
    out = tsolvers.jacobi_solve(xt, 0.2 * xt, 0.2, 1.0, maxiter=10)
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    x3 = np.random.default_rng(6).random((24, 30, 2)).astype(np.float32)
    for arr in (x, x3):
        ref = np.asarray(
            da.H1_regularization(
                jnp.asarray(arr), mu=1.0, omega=0.2, solver=JaxJacobi(maxiter=10)
            )
        )
        out = dt.H1_regularization(
            torch.from_numpy(arr), mu=1.0, omega=0.2, solver=dt.Jacobi(maxiter=10)
        )
        assert out.shape == ref.shape
        assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_quad_grid_and_patch_centers():
    pts = np.array([[3, 2], [60, 4], [58, 90], [1, 88]], dtype=float)
    ref = np.asarray(jax_quad_grid(pts, (55, 80)))
    assert np.abs(quad_coordinate_grid(pts, (55, 80), device=CPU).numpy() - ref).max() <= 1e-4
    for nv, n in [((96, 96), [2, 2]), ((1703, 3180), [8, 16]), ((50, 41), [3, 7])]:
        img = da.ScalarImage(np.zeros(nv, np.float32))
        ref = Patches(img, n, rel_overlap=0.1).centers_voxels.reshape(-1, 2)
        assert np.array_equal(patch_centers(nv, n), ref)


def test_window_geometry_and_curvature_stretch():
    img = np.random.default_rng(7).random((70, 90, 3)).astype(np.float32)
    j_ta = JaxTA(da.OpticalImage(img), N_patches=[3, 4], rel_overlap=0.15)
    t_ta = TranslationAnalysis(
        dt.OpticalImage(img, device="cpu"), N_patches=[3, 4], rel_overlap=0.15
    )
    jw, jc = j_ta._window_geometry()
    tw, tc = t_ta._window_geometry()
    assert tuple(jw) == tw and np.array_equal(jc, tc)
    cfg = {
        "init": {"horizontal_bulge": 1e-6, "vertical_center_offset": 3},
        "stretch": {"horizontal_stretch": -2e-6, "vertical_stretch": 1e-6},
    }
    jf, _ = da.CurvatureCorrection(config=cfg).pullback_field((70, 90))
    tf, _ = dt.CurvatureCorrection(config=cfg).pullback_field((70, 90), CPU)
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-4


def test_single_translation_and_numpy_dtypes():
    """A lone TranslationCorrection runs unfused (translate_array), and
    img_as takes numpy dtypes as the JAX package's callers pass them."""
    u8 = (np.random.default_rng(8).random((30, 40, 3)) * 255).astype(np.uint8)
    j = da.OpticalImage(u8, transformations=[da.TranslationCorrection([1.5, -0.5])])
    t = dt.OpticalImage(
        torch.from_numpy(u8), transformations=[dt.TranslationCorrection([1.5, -0.5])]
    )
    assert t.img.dtype == torch.uint8
    assert np.array_equal(t.img.numpy(), np.asarray(j.img))
    jf = np.asarray(j.img_as(np.float32).img)
    assert np.array_equal(t.img_as(np.float32).img.numpy(), jf)


def test_coordinate_system():
    j = da.OpticalImage(np.zeros((40, 60, 3), np.float32), width=2.0, height=1.5)
    t = dt.OpticalImage(torch.zeros((40, 60, 3)), width=2.0, height=1.5)
    vox = np.array([[0, 0], [39, 59], [10, 20]])
    ref = np.asarray(j.coordinatesystem.coordinate(vox))
    assert np.allclose(t.coordinatesystem.coordinate(vox), ref)
    assert np.allclose(t.origin, np.asarray(j.origin))
    assert t.voxel_size == j.voxel_size
