"""The port's flexible and multiscale registration lanes against the JAX package.

Scenes of ``tests/unit/test_registration.py`` (smooth random textures,
96x128), the same inputs handed to both packages, on the CPU.

Tolerances.  The JAX flexible lane interpolates with
``darsia_tpu.utils.interpolation.rbf_interpolate``, a float32 solve and
evaluation at pixel scale; the port solves in float64 in unit-scaled
coordinates.  Against a float64 numpy thin-plate spline (:func:`_tps64`,
independent of both) the port is off by the float32 rounding of its output
(~1e-7 px), JAX by its own float32 error, which each test computes on its
own data (`_jax_rbf_error`: ~3e-4 px at 96x128).  So the port is held to
JAX within JAX's error plus the port's (`_tol`).  Patch shifts come from two
FFT libraries and agree to 1e-3 px (tests/test_torch_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.ops.warp import warp_backend as jax_warp_backend
from darsia_tpu.restoration.averaging import uniform_filter
from darsia_tpu.utils.interpolation import rbf_interpolate as jax_rbf
from darsia_tpu_torch.analysis.translationanalysis import patch_centers
from darsia_tpu_torch.ops.warp import identity_grid, warp_backend
from darsia_tpu_torch.utils.interpolation import rbf_interpolate

torch.set_num_threads(1)

SHAPE = (96, 128)
#: The port's own error against the float64 spline: the float32 output.
PORT_ERR = 1e-6
#: Shift agreement of the two FFT libraries (tests/test_torch_pipeline.py).
SHIFT_TOL = 1e-3
#: The fused lane's float32 TPS error at the 4K geometry (1788x3180, 8x16
#: patches, coarse grid, shifts up to 3 px), measured by
#: ``test_fused_lane_tps_error_at_4k``: 6.0e-4 px.  chip_smoke.py bounds the
#: fused vs flexible fields at 4K by twice this figure (another matvec
#: summation order on the card).
FUSED_TPS_ERR_4K = 1e-3


def _textured(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    smooth = np.asarray(uniform_filter(jnp.asarray(rng.random(shape).astype(np.float32)), 7))
    return (smooth - smooth.min()) / (smooth.max() - smooth.min())


def _tps64(points, values, query):
    """Reference thin-plate spline in float64 at pixel scale (numpy)."""
    P, Q = np.asarray(points, float), np.asarray(query, float)
    n = len(P)

    def kernel(r):
        return np.where(r > 0, r * r * np.log(np.where(r > 0, r, 1.0)), 0.0)

    poly = np.c_[np.ones(n), P]
    A = np.block([[kernel(np.linalg.norm(P[:, None] - P[None], axis=-1)), poly],
                  [poly.T, np.zeros((3, 3))]])
    sol = np.linalg.solve(A, np.r_[np.asarray(values, float), np.zeros(3)])
    out = [
        kernel(np.linalg.norm(q[:, None] - P[None], axis=-1)) @ sol[:n] + sol[n] + q @ sol[n + 1:]
        for q in np.array_split(Q, max(1, len(Q) // 20000))
    ]
    return np.concatenate(out)


def _jax_rbf_error(points, values, query):
    """JAX's float32 error against the float64 spline at ``query``."""
    ref = _tps64(points, values, query)
    got = np.asarray(jax_rbf(points, values, jnp.asarray(query, jnp.float32)))
    return float(np.abs(got - ref).max())


def _tol(jax_error):
    return jax_error + PORT_ERR


def _grid_query(rows, cols):
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    return np.stack([cc.ravel(), rr.ravel()], axis=1).astype(np.float32)


def _scene(seed, shift, cls="ScalarImage"):
    base = _textured(seed)
    probe = np.roll(base, shift=shift, axis=(0, 1))
    j = [getattr(da, cls)(a, width=1.0, height=1.0) for a in (base, probe)]
    t = [getattr(dt, cls)(torch.from_numpy(a), width=1.0, height=1.0) for a in (base, probe)]
    return base, probe, j, t


def _interior(a):
    return np.asarray(a)[24:-24, 32:-32]


# ------------------------------------------------------------ interpolant


def _patch_points(H, W, N):
    c = patch_centers((H, W), N)
    bc = [p for y in np.linspace(0, H, N[0] + 1) for p in ([0.0, y], [float(W), y])]
    return np.r_[np.c_[c[:, 1], c[:, 0]], np.array(bc)], len(c)


@pytest.mark.parametrize(
    "H,W,N,coarse",
    [(96, 128, (4, 4), False), (96, 128, (3, 4), False), (1788, 3180, (8, 16), True)],
)
def test_rbf_interpolate_against_jax(H, W, N, coarse):
    points, n_centers = _patch_points(H, W, N)
    rng = np.random.default_rng(H + N[0])
    values = np.r_[rng.uniform(-3, 3, n_centers), np.zeros(len(points) - n_centers)]
    if coarse:
        CH, CW = -(-H // 16), -(-W // 16)
        rows = (np.arange(CH, dtype=np.float32) + 0.5) * np.float32(H / CH) - 0.5
        cols = (np.arange(CW, dtype=np.float32) + 0.5) * np.float32(W / CW) - 0.5
    else:
        rows, cols = np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32)
    query = _grid_query(rows, cols)
    ref = _tps64(points, values, query)
    port = rbf_interpolate(points, values, torch.from_numpy(query))
    assert port.dtype == torch.float32
    assert np.abs(port.numpy() - ref).max() <= PORT_ERR
    jax_error = _jax_rbf_error(points, values, query)
    # JAX's float32 conditioning: ~3e-4 px at 96x128, ~2.5e-2 px at 4K.
    assert jax_error <= (0.05 if coarse else 1e-3)
    jax_out = np.asarray(jax_rbf(points, values, jnp.asarray(query)))
    assert np.abs(port.numpy() - jax_out).max() <= _tol(jax_error)


def test_rbf_interpolate_smoothing_is_scale_exact():
    points, n = _patch_points(96, 128, (3, 4))
    values = np.r_[np.linspace(-2, 2, n), np.zeros(len(points) - n)]
    query = _grid_query(np.arange(0, 96, 7.0), np.arange(0, 128, 9.0))
    got = rbf_interpolate(points, values, torch.from_numpy(query), smoothing=50.0).numpy()
    # The same smoothed spline solved at pixel scale in float64.
    P = points.astype(float)
    r = np.linalg.norm(P[:, None] - P[None], axis=-1)
    K = np.where(r > 0, r * r * np.log(np.where(r > 0, r, 1.0)), 0.0) + 50.0 * np.eye(len(P))
    poly = np.c_[np.ones(len(P)), P]
    sol = np.linalg.solve(np.block([[K, poly], [poly.T, np.zeros((3, 3))]]), np.r_[values, 0, 0, 0])
    rq = np.linalg.norm(query[:, None].astype(float) - P[None], axis=-1)
    Kq = np.where(rq > 0, rq * rq * np.log(np.where(rq > 0, rq, 1.0)), 0.0)
    ref = Kq @ sol[: len(P)] + sol[len(P)] + query @ sol[len(P) + 1:]
    assert np.abs(got - ref).max() <= PORT_ERR


def test_fused_lane_tps_error_at_4k():
    """The figure chip_smoke.py bounds the 4K fused vs flexible fields by."""
    from darsia_tpu_torch.analysis.translationanalysis import (
        _tps_eval_matrix,
        _tps_system_inverse,
    )

    H, W = 1788, 3180
    points, n = _patch_points(H, W, (8, 16))
    points = points.astype(np.float32)
    values = np.r_[np.random.default_rng(1).uniform(-3, 3, n), np.zeros(len(points) - n)]
    CH, CW = -(-H // 16), -(-W // 16)
    query = _grid_query((np.arange(CH) + 0.5) * (H / CH) - 0.5, (np.arange(CW) + 0.5) * (W / CW) - 0.5)
    s = 1.0 / max(H, W)
    ainv = torch.tensor(_tps_system_inverse(points * s), dtype=torch.float32)
    e = torch.tensor(_tps_eval_matrix(points * s, query * s), dtype=torch.float32)
    v = torch.tensor(np.r_[values, np.zeros(3)], dtype=torch.float32)
    fused = (e @ (ainv @ v)).numpy()
    flexible = rbf_interpolate(points, values, torch.from_numpy(query)).numpy()
    ref = _tps64(points, values, query)
    assert np.abs(flexible - ref).max() <= PORT_ERR
    assert np.abs(fused - ref).max() <= FUSED_TPS_ERR_4K
    assert np.abs(fused - flexible).max() <= FUSED_TPS_ERR_4K + PORT_ERR


@pytest.mark.parametrize("shape,coarse", [((96, 128), False), ((192, 256), True)])
def test_displacement_field_against_jax(shape, coarse):
    """Dense at 96x128; the coarse 1/16 grid forced at 192x256, as
    tests/unit/test_registration.py:126-152 forces it."""
    H, W = shape
    gy, gx = np.meshgrid(np.linspace(10, H - 12, 5), np.linspace(10, W - 10, 7), indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    data = (pts, 3.0 * np.sin(gx.ravel() / 80.0), pts, 2.0 * np.cos(gy.ravel() / 60.0))
    j_ta = da.TranslationAnalysis(da.ScalarImage(np.zeros(shape, np.float32)), [2, 2], 0.1)
    t_ta = dt.TranslationAnalysis(dt.ScalarImage(np.zeros(shape, np.float32), device="cpu"), [2, 2], 0.1)
    j_ta._displacement_data = t_ta._displacement_data = data
    dense_t = t_ta.displacement_field(shape)
    if coarse:
        j_ta.COARSE_THRESHOLD = t_ta.COARSE_THRESHOLD = 0
        CH, CW = -(-H // 16), -(-W // 16)
        rows = (np.arange(CH, dtype=np.float32) + 0.5) * np.float32(H / CH) - 0.5
        cols = (np.arange(CW, dtype=np.float32) + 0.5) * np.float32(W / CW) - 0.5
    else:
        rows, cols = np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32)
    query = _grid_query(rows, cols)
    # Bilinear upsampling is a convex combination: the coarse nodes' error bounds it.
    jax_error = max(_jax_rbf_error(data[0], data[1], query), _jax_rbf_error(data[2], data[3], query))
    j = np.asarray(j_ta.displacement_field(shape))
    t = t_ta.displacement_field(shape)
    assert t.shape == (2, H, W) and t.dtype == torch.float32
    assert np.abs(t.numpy() - j).max() <= _tol(jax_error)
    if coarse:
        # The coarse lane against the dense one (test_registration.py:150-152).
        scale = dense_t.abs().max()
        assert (t - dense_t).abs().mean() < 0.02 * scale
        assert (t - dense_t).abs().max() < 0.2 * scale


# ------------------------------------------------------------ flexible lane


@pytest.fixture(scope="module")
def flexible():
    base, probe, (jb, jp), (tb, tp) = _scene(0, (3, 5))
    j_ta = da.TranslationAnalysis(jb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)
    t_ta = dt.TranslationAnalysis(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)
    j_ta.load_image(jp)
    t_ta.load_image(tp)
    j_res = j_ta.find_translation()
    t_res = t_ta.find_translation()
    return {"base": base, "probe": probe, "jax": (j_ta, j_res), "torch": (t_ta, t_res), "tp": tp, "jp": jp}


def _field_tol(j_ta):
    """JAX's error on its own interpolant data at the dense grid, plus the
    spread of the two FFT libraries' shifts (a unit change of one TPS value
    moves the field by at most ~1, here bounded by 2)."""
    j_ta._flush_pending_shifts()
    pts_x, vals_x, pts_y, vals_y = j_ta._displacement_data
    query = _grid_query(np.arange(SHAPE[0], dtype=np.float32), np.arange(SHAPE[1], dtype=np.float32))
    jax_error = max(_jax_rbf_error(pts_x, vals_x, query), _jax_rbf_error(pts_y, vals_y, query))
    return _tol(jax_error) + 2 * SHIFT_TOL


def test_find_translation_shifts(flexible):
    (j_ta, (_, j_ok)), (t_ta, (t_fn, t_ok)) = flexible["jax"], flexible["torch"]
    assert j_ok and t_ok
    assert np.array_equal(t_ta.have_translation, j_ta.have_translation)
    for k in range(4):
        assert np.allclose(t_ta._displacement_data[k], j_ta._displacement_data[k], atol=SHIFT_TOL, rtol=0)
    # The uniform shift recovered (tests/unit/test_registration.py:43-58).
    disp = t_fn(np.array([[64.0, 48.0]]))
    assert abs(disp[0, 0] + 5) < 1.0 and abs(disp[1, 0] + 3) < 1.0
    # find_translation caches the base spectra per geometry and device.
    key, spectra = t_ta._base_spectra
    t_ta.find_translation()
    assert t_ta._base_spectra[1] is spectra


def test_translation_callable_and_field(flexible):
    (j_ta, _), (t_ta, _) = flexible["jax"], flexible["torch"]
    tol = _field_tol(j_ta)
    pts = np.array([[64.0, 48.0], [10.5, 3.25], [127.0, 95.0]])
    assert np.abs(np.asarray(t_ta.translation(pts)) - np.asarray(j_ta.translation(pts))).max() <= tol
    field_t = t_ta.displacement_field(SHAPE)
    assert np.abs(field_t.numpy() - np.asarray(j_ta.displacement_field(SHAPE))).max() <= tol
    patch_t = t_ta.return_patch_translation(units="pixel")
    patch_j = j_ta.return_patch_translation(units="pixel")
    assert patch_t.shape == (3, 4, 2)
    assert np.abs(patch_t - patch_j).max() <= tol


def test_translate_image_against_jax_gather(flexible):
    (j_ta, _), (t_ta, _) = flexible["jax"], flexible["torch"]
    aligned_t = t_ta.translate_image()
    aligned_j = j_ta.translate_image()
    base, probe = flexible["base"], flexible["probe"]
    a_t, a_j = aligned_t.img.numpy(), np.asarray(aligned_j.img)
    # A field difference dx moves a bilinear sample by at most dx times the
    # image's largest one-pixel step (plus filled border pixels, see below).
    step = max(np.abs(np.diff(probe, axis=0)).max(), np.abs(np.diff(probe, axis=1)).max())
    off = np.abs(a_t - a_j) > 2 * _field_tol(j_ta) * step + 1e-6
    # A sample within rounding of the domain edge lands on either side of
    # the mode="constant" mask (tests/test_torch_pipeline.py).
    assert off.sum() <= 4
    assert all(a_t[p] == 0 or a_j[p] == 0 for p in zip(*np.nonzero(off)))
    # test_registration.py:60-68 on the port.
    err = np.abs(_interior(a_t) - _interior(base)).mean()
    assert err < 0.05 and err < 0.5 * np.abs(_interior(probe) - _interior(base)).mean()


def test_translate_image_rounds_integer_images(flexible):
    (_, _), (t_ta, _) = flexible["jax"], flexible["torch"]
    u8 = dt.ScalarImage(torch.from_numpy((flexible["probe"] * 255).astype(np.uint8)), width=1.0, height=1.0)
    out = t_ta.translate_image(u8)
    ref = t_ta.translate_image(u8.img_as(torch.float32) * 255.0)
    assert out.img.dtype == torch.uint8
    assert torch.equal(out.img, torch.round(ref.img).to(torch.uint8))


def test_two_pass_warp_against_pallas(flexible):
    """The port's two-pass path (plain K1) against JAX's Pallas kernel in
    interpret mode on the flexible lane's coordinates: the tight tier."""
    (_, _), (t_ta, _) = flexible["jax"], flexible["torch"]
    disp = t_ta.displacement_field(SHAPE)
    coords = identity_grid(SHAPE, "cpu") - disp
    max_disp = int(np.ceil(float(disp.abs().max()))) + 1
    data = flexible["probe"]
    out_t = warp_backend(torch.from_numpy(data), coords, max_disp=max_disp, force="kernel")
    out_j = jax_warp_backend(jnp.asarray(data), jnp.asarray(coords.numpy()), max_disp=max_disp, force="pallas")
    assert np.abs(out_t.numpy() - np.asarray(out_j)).max() <= 1e-6


# ---------------------------------------------------------------- facade


@pytest.fixture(scope="module")
def facades():
    base, probe, (jb, jp), (tb, tp) = _scene(2, (2, -4))
    out = {"base": base, "probe": probe}
    for fused in (True, False):
        kw = {"N_patches": [3, 3], "rel_overlap": 0.3, "quality_tol": 0.01, "fused": fused}
        j_reg, t_reg = da.ImageRegistration(jb, **kw), dt.ImageRegistration(tb, **kw)
        out[fused] = (j_reg, t_reg, j_reg(jp), t_reg(tp))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_facade_displacement_apply_evaluate(facades, fused):
    j_reg, t_reg, j_out, t_out = facades[fused]
    base, probe = facades["base"], facades["probe"]
    tol = _field_tol(j_reg._engine.translation_analysis)
    # test_registration.py:71-99 on the port.
    err = np.abs(_interior(t_out.img) - _interior(base)).mean()
    assert err < 0.05 and err < 0.5 * np.abs(_interior(probe) - _interior(base)).mean()

    field = t_reg.displacement()
    assert isinstance(field, torch.Tensor) and field.shape == (2, 96, 128)
    assert np.abs(field.numpy() - j_reg.displacement()).max() <= tol
    for units in ("pixel", "metric"):
        pts = np.array([[64.0, 48.0], [20.0, 70.0]]) if units == "pixel" else np.array([[0.5, 0.5], [0.2, 0.3]])
        d_t, d_j = t_reg.evaluate(pts, units=units), j_reg.evaluate(pts, units=units)
        assert d_t.shape == (2, 2) and np.isfinite(d_t).all()
        scale = 1.0 if units == "pixel" else 1.0 / 96
        assert np.abs(d_t - d_j).max() <= tol * scale
    assert abs(t_reg.evaluate(np.array([[64.0, 48.0]]), units="pixel")[0, 0] - 4) < 1.0

    other = dt.ScalarImage(torch.from_numpy(probe.copy()), width=1.0, height=1.0)
    applied = t_reg.apply(other)
    assert np.abs(_interior(applied.img) - _interior(base)).mean() < 0.05
    j_applied = j_reg.apply(da.ScalarImage(probe.copy(), width=1.0, height=1.0))
    step = max(np.abs(np.diff(probe, axis=0)).max(), np.abs(np.diff(probe, axis=1)).max())
    assert np.abs(_interior(applied.img) - _interior(j_applied.img)).max() <= 2 * tol * step + 1e-6


def test_facade_fused_matches_flexible():
    """tests/unit/test_registration.py:155-190 on the port."""
    base, probe, _, (tb, tp) = _scene(5, (3, -4))
    flexible = dt.TranslationAnalysis(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)
    aligned_flex = flexible(tp)
    fused = dt.TranslationAnalysis(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)
    aligned_fused = fused.fused_align(tp)
    a, b = _interior(aligned_fused.img), _interior(aligned_flex.img)
    assert np.abs(a - b).mean() < 0.02
    assert np.abs(a - _interior(base)).mean() < 0.05
    # The fused lane's staged shifts materialize the same state.
    assert fused.have_translation.all()
    assert abs(float(fused.translation(np.array([[64.0, 48.0]]))[0, 0]) - 4) < 1.5
    # Every patch passes, so the staged shifts give the flexible field.
    assert (fused.displacement_field(SHAPE) - flexible.displacement_field(SHAPE)).abs().max() <= 1e-5
    reg = dt.ImageRegistration(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01, fused=True)
    assert np.abs(_interior(reg(tp).img) - a).mean() < 1e-5


def test_mask_routes_to_flexible_lane():
    base, probe, _, (tb, tp) = _scene(5, (3, -4))
    mask = dt.ScalarImage(torch.ones(SHAPE, dtype=torch.bool), width=1.0, height=1.0)
    reg = dt.DiffeomorphicImageRegistration(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01, mask_dst=mask)
    assert reg.translation_analysis.mask_base is mask
    masked = reg(tp, mask=mask)
    flex = dt.TranslationAnalysis(tb, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)(tp)
    assert torch.equal(masked.img, flex.img)
    assert reg.translation_analysis._fused is None  # the fused lane never ran
    transformed, dst = reg(tp, return_transformed_dst=True)
    assert dst.img.shape == tb.img.shape
    _, patches = reg.call_with_output(tp, return_patch_translation=True)
    assert patches.shape == (3, 4, 2)


def test_deduct_and_add_translation_analysis():
    _, _, _, (tb, tp) = _scene(5, (3, -4))
    kw = {"N_patches": [3, 4], "rel_overlap": 0.3, "quality_tol": 0.01}
    a, b = dt.DiffeomorphicImageRegistration(tb, **kw), dt.DiffeomorphicImageRegistration(tb, **kw)
    a(tp)
    b.deduct(a)
    pts = np.array([[64.0, 48.0]])
    assert np.array_equal(b.evaluate(pts, "pixel"), a.evaluate(pts, "pixel"))
    b.add(a)
    assert np.allclose(b.evaluate(pts, "pixel"), 2 * a.evaluate(pts, "pixel"))


# ------------------------------------------------------------- multiscale


def test_multiscale_against_jax():
    base, probe, (jb, jp), (tb, tp) = _scene(4, (3, -2))
    kw = {"N_patches": [2, 2], "rel_overlap": 0.3, "quality_tol": 0.01, "num_levels": 3}
    j_reg, t_reg = da.ImageRegistration(jb, **kw), dt.ImageRegistration(tb, **kw)
    assert isinstance(t_reg._engine, dt.MultiscaleDiffeomorphicImageRegistration)
    j_out, t_out = j_reg(jp), t_reg(tp)
    j_field, t_field = j_reg.displacement(), t_reg.displacement()
    assert t_field.shape == (2, 96, 128)
    # Three levels of shifts, each within the FFT spread scaled up by its
    # factor (4, 2, 1), and each level's interpolant within JAX's error.
    ta = j_reg._engine.translation_analysis
    tol = (4 + 2 + 1) * (_field_tol(ta))
    assert np.abs(t_field.numpy() - np.asarray(j_field)).max() <= tol
    step = max(np.abs(np.diff(probe, axis=0)).max(), np.abs(np.diff(probe, axis=1)).max())
    assert np.abs(_interior(t_out.img) - _interior(j_out.img)).max() <= tol * step + 1e-6
    err = np.abs(_interior(t_out.img) - _interior(base)).mean()
    assert err < 0.5 * np.abs(_interior(probe) - _interior(base)).mean()
    applied = t_reg.apply(tp)
    assert torch.equal(applied.img, t_out.img)
    assert np.abs(_interior(t_reg.apply(tp, reverse=False).img) - _interior(j_reg.apply(jp, reverse=False).img)).max() <= tol * step + 1e-6
    d = t_reg.evaluate(np.array([[0.5, 0.5]]), units="metric")
    assert d.shape == (1, 2) and np.isfinite(d).all()


def test_multiscale_truncates_integer_images():
    base, probe, _, _ = _scene(4, (3, -2))
    tb = dt.ScalarImage(torch.from_numpy((base * 255).astype(np.uint8)), width=1.0, height=1.0)
    tp = dt.ScalarImage(torch.from_numpy((probe * 255).astype(np.uint8)), width=1.0, height=1.0)
    reg = dt.ImageRegistration(tb, N_patches=[2, 2], rel_overlap=0.3, quality_tol=0.01, num_levels=2)
    out = reg(tp)
    field = reg.displacement()
    coords = identity_grid(SHAPE, "cpu") - field
    warped = warp_backend(tp.img.to(torch.float32), coords, max_disp=int(np.ceil(float(field.abs().max()))) + 1)
    assert out.img.dtype == torch.uint8
    assert torch.equal(out.img, warped.to(torch.uint8))
