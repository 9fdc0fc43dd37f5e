"""The port's shape-side rig corrections against the JAX package: phase
correlation, translation estimation, drift correction, the fused
drift + curvature chain (alone, in the pipeline and on a drifting series),
the curvature tuning helpers and I/O, and the bounding-box helpers.

Scenes: the smooth 48x64 image of ``tests/unit/test_fused_chain.py`` (drift
ROI (4:44, 4:60)) and the 96x128 pipeline scene of
``tests/test_torch_pipeline.py``.  The same numpy inputs go through both
packages on the CPU, where both warp with the exact gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import META, _base_u8, _objects

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.corrections.fuse import FusedCorrectionChain as JaxChain
from darsia_tpu.ops.fft import phase_correlation as jax_phase_correlation
from darsia_tpu.utils import box as jax_box
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.corrections import fuse
from darsia_tpu_torch.corrections.fuse import FusedCorrectionChain, fused_chain
from darsia_tpu_torch.ops.fft import phase_correlation
from darsia_tpu_torch.utils import box

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROI = (slice(4, 44), slice(4, 60))
#: Phase-correlation shifts of the two FFT libraries, px.
SHIFT_TOL = 1e-4
#: Float frames through the same warp: mean |diff|.
FLOAT_MEAN_TOL = 1e-5
#: uint8 frames: a field difference at float rounding can flip a value that
#: sits at a half by one level, on at most this share of the pixels.
U8_FLIP_SHARE = 1e-3


def _smooth_image(h=48, w=64, c=3, seed=0):
    """tests/unit/test_fused_chain.py's scene."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack(
        [np.sin(3 * np.pi * xx + k) * np.cos(2 * np.pi * yy) for k in range(c)], axis=-1
    )
    return (0.5 + 0.4 * base + 0.02 * rng.random((h, w, c))).astype(np.float32)


def _curvature_config(h, w):
    return {
        "crop": {
            "pts_src": [[2, 3], [h - 3, 2], [h - 2, w - 4], [3, w - 2]],
            "width": 1.0,
            "height": 1.0,
        },
        "bulge": {"horizontal_bulge": 1e-6, "vertical_bulge": 2e-6},
    }


@pytest.fixture(scope="module")
def scene():
    base = _smooth_image(seed=1)
    h, w = base.shape[:2]
    cfg = _curvature_config(h, w)
    return {
        "base": base,
        "jax": (da.DriftCorrection(base=base, config={"roi": ROI}), da.CurvatureCorrection(config=cfg)),
        "torch": (dt.DriftCorrection(base=base, config={"roi": ROI}), dt.CurvatureCorrection(config=cfg)),
    }


def _assert_u8_close(a: np.ndarray, b: np.ndarray) -> None:
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= U8_FLIP_SHARE


# ---------------------------------------------------------- estimation


@pytest.mark.parametrize("shift", [(2, 3), (-3, 1), (0, -5)])
@pytest.mark.parametrize("shape", [(48, 64), (37, 50)])
def test_phase_correlation_against_jax(shift, shape):
    rng = np.random.default_rng(sum(shape))
    dst = _smooth_image(*shape, c=1, seed=2)[..., 0] + 0.05 * rng.random(shape, np.float32)
    src = np.roll(dst, shift, axis=(0, 1))
    j_shift, j_quality = jax_phase_correlation(jnp.asarray(src), jnp.asarray(dst))
    t_shift, t_quality = phase_correlation(torch.from_numpy(src), torch.from_numpy(dst))
    assert t_shift.shape == (2,) and t_shift.dtype == torch.float32
    assert np.abs(t_shift.numpy() - np.asarray(j_shift)).max() <= SHIFT_TOL
    assert abs(float(t_quality) - float(j_quality)) <= 1e-5
    # The wrap-around mapping: a roll by s is found as -s.
    assert np.abs(t_shift.numpy() + np.array(shift)).max() < 0.1


def test_translation_estimator_against_jax(scene):
    base = scene["base"]
    img = np.roll(base, shift=(2, 3), axis=(0, 1))
    roi_src, roi_dst = (slice(6, 40), slice(5, 55)), (slice(4, 40), slice(4, 58))
    j = da.TranslationEstimator().find_effective_translation(jnp.asarray(img), base, roi_src, roi_dst)
    t = dt.TranslationEstimator().find_effective_translation(torch.from_numpy(img), base, roi_src, roi_dst)
    assert t[1] == j[1] is True
    assert np.abs(t[0] - np.asarray(j[0])).max() <= SHIFT_TOL
    aligned = dt.TranslationEstimator().match_roi(torch.from_numpy(img), base, ROI, ROI)
    j_aligned = da.TranslationEstimator().match_roi(jnp.asarray(img), base, ROI, ROI)
    assert np.abs(aligned.numpy() - np.asarray(j_aligned)).mean() <= FLOAT_MEAN_TOL


def test_translation_correction_from_file(tmp_path):
    da.TranslationCorrection([1.5, -2.25]).save(tmp_path / "t")
    corr = dt.TranslationCorrection(tmp_path / "t.npz")
    assert np.array_equal(corr.translation, [1.5, -2.25])
    img = _smooth_image()
    out = corr.correct_array(torch.from_numpy(img)).numpy()
    j_out = np.asarray(da.TranslationCorrection([1.5, -2.25]).correct_array(jnp.asarray(img)))
    assert np.abs(out - j_out).max() <= 1e-6


# --------------------------------------------------------------- drift


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_drift_correct_array_against_jax(scene, dtype):
    jd, _ = scene["jax"]
    td, _ = scene["torch"]
    img = np.roll(scene["base"], shift=(2, 3), axis=(0, 1))
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    j_out = np.asarray(jd.correct_array(jnp.asarray(img)))
    t_out = td.correct_array(torch.from_numpy(img)).numpy()
    assert t_out.dtype == img.dtype and t_out.shape == img.shape
    if dtype == "uint8":
        _assert_u8_close(t_out, j_out)
    else:
        assert np.abs(t_out - j_out).mean() <= FLOAT_MEAN_TOL


@pytest.mark.parametrize("shift", [(2, 3), (-1, 4), (0, 0)])
def test_pullback_translation_against_jax(scene, shift):
    jd, _ = scene["jax"]
    td, _ = scene["torch"]
    img = np.roll(scene["base"], shift=shift, axis=(0, 1))
    t = td.pullback_translation(torch.from_numpy(img))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.shape == (2,)
    assert np.abs(t.numpy() - np.asarray(jd.pullback_translation(jnp.asarray(img)))).max() <= SHIFT_TOL
    assert np.abs(t.numpy() - np.array(shift)).max() < 0.1


def test_drift_config_from_corner_voxels():
    base = _smooth_image()
    voxels = np.array([[5, 7], [30, 7], [30, 50], [5, 50]])
    cfg = {"roi": voxels, "padding": 0.05}
    j, t = da.DriftCorrection(base, cfg), dt.DriftCorrection(base, cfg)
    assert t.roi == j.roi and t.return_config() == j.return_config()
    assert t.max_displacement == j.max_displacement == 64.0
    inactive = dt.DriftCorrection(base, {"active": False})
    img = torch.from_numpy(np.roll(base, 1, axis=0))
    assert inactive.correct_array(img) is img
    assert torch.equal(inactive.pullback_translation(img), torch.zeros(2))


def test_pullback_translation_zeroes_non_finite(scene):
    td, _ = scene["torch"]
    img = torch.from_numpy(scene["base"]).clone()
    img[10, 10, 0] = float("nan")
    t = td.pullback_translation(img)
    assert torch.isfinite(t).all()


def test_drift_prepares_the_baseline_spectrum_once(scene, monkeypatch):
    """Both uses share one estimator: the baseline's spectrum is prepared
    once per device and window shape, and after the first estimate no
    constant is copied from the host."""
    from darsia_tpu_torch.corrections.shape import drift as drift_module

    td = dt.DriftCorrection(base=scene["base"], config={"roi": ROI})
    prepared, prepare = [], drift_module.prepare_phase_reference

    def counting(window):
        prepared.append(tuple(window.shape))
        return prepare(window)

    monkeypatch.setattr(drift_module, "prepare_phase_reference", counting)
    img = torch.from_numpy(np.roll(scene["base"], shift=(2, 3), axis=(0, 1)))
    first = td.pullback_translation(img)

    def refuse(*args, **kwargs):
        raise AssertionError("a host constant copied per estimate")

    monkeypatch.setattr(torch, "tensor", refuse)
    again = td.pullback_translation(img)
    monkeypatch.undo()
    corrected = td.correct_array(img)
    assert prepared == [(1, 40, 56)] and torch.equal(first, again)
    j_out = np.asarray(scene["jax"][0].correct_array(jnp.asarray(img.numpy())))
    assert np.abs(corrected.numpy() - j_out).mean() <= FLOAT_MEAN_TOL


# ------------------------------------------------- the fused drift chain


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_fused_drift_chain_against_jax(scene, dtype):
    base = scene["base"]
    h, w = base.shape[:2]
    jf = JaxChain(list(scene["jax"]), (h, w))
    tf = FusedCorrectionChain(list(scene["torch"]), (h, w), CPU)
    # ceil(static) + 1 + ceil(max_displacement), as the JAX package bounds it.
    assert tf.max_disp == jf.max_disp == int(np.ceil(tf.static_disp)) + 1 + 64
    assert tf.out_shape == jf.out_shape
    img = np.roll(base, shift=(2, 3), axis=(0, 1))
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    j_out = np.asarray(jf.correct_array(jnp.asarray(img)))
    t_out = tf.correct_array(torch.from_numpy(img)).numpy()
    assert t_out.dtype == img.dtype and t_out.shape == j_out.shape
    if dtype == "uint8":
        _assert_u8_close(t_out, j_out)
    else:
        assert np.abs(t_out - j_out).mean() <= FLOAT_MEAN_TOL


def test_fused_drift_chain_is_one_warp_without_host_reads(scene, monkeypatch):
    """One warp per image; the translation never leaves the device (on the
    CPU: no ``.item()``, ``float()``, ``.cpu()`` or ``.numpy()`` of a tensor
    while the chain applies)."""
    base = scene["base"]
    chain = FusedCorrectionChain(list(scene["torch"]), base.shape[:2], CPU)
    img = torch.from_numpy(np.roll(base, shift=(1, -2), axis=(0, 1)))
    calls = []
    warp_backend = fuse.warp_backend

    def counting(*args, **kwargs):
        calls.append(kwargs["max_disp"])
        return warp_backend(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("host read of a tensor in the fused chain")

    monkeypatch.setattr(fuse, "warp_backend", counting)
    for name in ("item", "__float__", "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = chain.correct_array(img)
    monkeypatch.undo()
    assert calls == [chain.max_disp]
    assert out.shape == chain.out_shape + (3,)


def test_drift_fuses_only_at_chain_start(scene):
    td, tc = scene["torch"]
    with pytest.raises(ValueError, match="chain start"):
        FusedCorrectionChain([tc, td], scene["base"].shape[:2], CPU)
    assert fuse._collect_group([td, tc, td], 0) == 2
    assert fuse.is_dynamic_fusable(td) and not fuse.is_static_fusable(td)


def test_image_constructor_fuses_drift_against_jax(scene):
    img = (np.roll(scene["base"], shift=(2, 3), axis=(0, 1)) * 255).astype(np.uint8)
    j_img = da.OpticalImage(jnp.asarray(img), transformations=list(scene["jax"]), **META)
    t_img = dt.OpticalImage(torch.from_numpy(img), transformations=list(scene["torch"]), **META)
    _assert_u8_close(t_img.img.numpy(), np.asarray(j_img.img))
    assert np.allclose(t_img.dimensions, j_img.dimensions)
    # A lone drift member is not fused: the host-read correction runs.
    j_one = da.OpticalImage(jnp.asarray(img), transformations=[scene["jax"][0]], **META)
    t_one = dt.OpticalImage(torch.from_numpy(img), transformations=[scene["torch"][0]], **META)
    _assert_u8_close(t_one.img.numpy(), np.asarray(j_one.img))


# ---------------------------------------------------- drifting series


def test_drifting_series_frame_equals_alone(scene):
    base = scene["base"]
    frames = [np.roll(base, shift=(k, 2 - k), axis=(0, 1)) for k in range(4)]
    series = torch.from_numpy((np.stack(frames, axis=2) * 255).astype(np.uint8))
    members = list(scene["torch"])
    chain = fused_chain(members, base.shape[:2], CPU)
    out = chain.correct_series_array(series, 2)
    assert out.shape == chain.out_shape + (4, 3) and out.dtype == torch.uint8
    for k in range(4):
        assert torch.equal(out[:, :, k], chain.correct_array(series[:, :, k].contiguous()))
    meta = {"series": True, "time": [0.0, 1.0, 2.0, 3.0], **META}
    t_img = dt.OpticalImage(series, transformations=members, **meta)
    assert torch.equal(t_img.img, out)
    j_img = da.OpticalImage(jnp.asarray(series.numpy()), transformations=list(scene["jax"]), **meta)
    _assert_u8_close(t_img.img.numpy(), np.asarray(j_img.img))


# --------------------------------------------------------- in the pipeline


@pytest.fixture(scope="module")
def pipeline_scene():
    """The pipeline scene with a drift member leading the chain."""
    base_u8 = _base_u8()
    probe = np.roll(base_u8, shift=(1, 2), axis=(0, 1))
    roi = (slice(10, 80), slice(10, 110))
    out = {"probe": probe}
    for name, pkg, jacobi, as_input in (
        ("jax", da, JaxJacobi, jnp.asarray),
        ("torch", dt, dt.Jacobi, torch.from_numpy),
    ):
        objs = _objects(pkg, jacobi, base_u8, as_input)
        drift = pkg.DriftCorrection(base=base_u8, config={"roi": roi})
        objs["drift"] = drift
        objs["pipe"] = pkg.FusedAnalysisPipeline(
            transformations=[drift, objs["curv"]],
            registration=objs["registration"],
            analysis=objs["analysis"],
        )
        objs["chain_only"] = pkg.FusedAnalysisPipeline(transformations=[drift, objs["curv"]])
        out[name] = objs
    return out


def test_pipeline_with_drift_member_against_jax(pipeline_scene):
    j, t, probe = pipeline_scene["jax"], pipeline_scene["torch"], pipeline_scene["probe"]
    stages, _ = t["pipe"]._stage_plan(probe.shape[:2], CPU)
    assert [kind for kind, _ in stages] == ["chain"] and stages[0][1]._dynamic is t["drift"]
    j_conc = np.asarray(j["pipe"](jnp.asarray(probe)).img)
    t_conc = t["pipe"](torch.from_numpy(probe)).img.numpy()
    # The tolerance the pipeline is held to (tests/test_torch_pipeline.py).
    assert np.abs(t_conc - j_conc).max() <= 1e-4
    for as_float in (False, True):
        frame = probe.astype(np.float32) / 255.0 if as_float else probe
        j_out = np.asarray(j["chain_only"](da.OpticalImage(jnp.asarray(frame), **META)).img)
        t_out = t["chain_only"](dt.OpticalImage(torch.from_numpy(frame), **META)).img.numpy()
        if as_float:
            assert np.abs(t_out - j_out).mean() <= FLOAT_MEAN_TOL
        else:
            # uint8 frames are rounded by the chain, then mapped to [0, 1].
            _assert_u8_close(np.round(t_out * 255), np.round(j_out * 255))


def test_pipeline_with_drift_member_matches_staged(pipeline_scene):
    """The fused frame equals the staged public objects (the corrected Image
    through the registration and the analysis)."""
    t, probe = pipeline_scene["torch"], pipeline_scene["probe"]
    fused = t["pipe"](torch.from_numpy(probe)).img
    corrected = dt.OpticalImage(torch.from_numpy(probe), transformations=[t["drift"], t["curv"]], **META)
    staged = t["analysis"](t["registration"](corrected.img_as(torch.float32))).img
    assert (fused - staged).abs().mean() <= 1e-5


def test_single_warp_refuses_drift(pipeline_scene):
    t, probe = pipeline_scene["torch"], pipeline_scene["probe"]
    pipe = dt.FusedAnalysisPipeline(
        transformations=[t["drift"], t["curv"]], registration=t["registration"], single_warp=True
    )
    with pytest.raises(ValueError, match="drift"):
        pipe(torch.from_numpy(probe))


# ------------------------------------------- curvature helpers and I/O


@pytest.fixture()
def tuning():
    img = (_smooth_image(60, 90) * 255).astype(np.uint8)
    kw = {"width": 1.5, "height": 1.0}
    return img, da.CurvatureCorrection(image=img, **kw), dt.CurvatureCorrection(image=img, device="cpu", **kw)


def test_curvature_tuning_helpers_against_jax(tuning):
    img, j, t = tuning
    assert np.array_equal(t.temporary_image, j.temporary_image)
    for corr in (j, t):
        corr.pre_bulge_correction(horizontal_bulge=2e-6, vertical_bulge=-1e-6)
        corr.crop([[3, 4], [57, 2], [58, 88], [2, 86]])
    assert t.config["init"] == j.config["init"]
    assert np.array_equal(t.config["crop"]["pts_src"], np.asarray(j.config["crop"]["pts_src"]))
    _assert_u8_close(t.temporary_image, j.temporary_image)
    kw = {"left": 3, "right": 1, "top": 2, "bottom": 1}
    assert t.compute_bulge(**kw) == j.compute_bulge(**kw)
    stretch = {"point_source": [40, 20], "point_destination": [42, 21], "stretch_center": [30, 25]}
    assert t.compute_stretch(**stretch) == j.compute_stretch(**stretch)
    for corr in (j, t):
        corr.bulge_correction(**kw)
        corr.stretch_correction(**stretch)
    assert t.config["bulge"] == j.config["bulge"] and t.config["stretch"] == j.config["stretch"]
    _assert_u8_close(t.temporary_image, j.temporary_image)
    image = t.return_image()
    assert image.dimensions == [1.0, 1.5] and torch.equal(image.img, t.current_image)
    # The tuned config corrects a fresh image as the JAX package's does.
    j_out = np.asarray(j.correct_array(jnp.asarray(img)))
    t_out = t.correct_array(torch.from_numpy(img)).numpy()
    _assert_u8_close(t_out, j_out)


def test_curvature_config_files_and_resize_factor(tmp_path):
    h, w = 48, 64
    cfg = _curvature_config(h, w) | {"stretch": {"horizontal_stretch": 1e-7}}
    t = dt.CurvatureCorrection(config=cfg)
    t.write_config_to_file(tmp_path / "c.json")
    j = da.CurvatureCorrection(config=tmp_path / "c.json")
    back = dt.CurvatureCorrection(config=tmp_path / "c.json")
    other = dt.CurvatureCorrection()
    other.read_config_from_file(tmp_path / "c.json")
    assert back.config.keys() == j.config.keys() == other.config.keys()
    j_half = da.CurvatureCorrection(config=cfg, resize_factor=0.5)
    t_half = dt.CurvatureCorrection(config=cfg, resize_factor=0.5)
    for key in ("bulge", "stretch"):
        assert t_half.config[key] == j_half.config[key]
    assert np.array_equal(t_half.config["crop"]["pts_src"], np.asarray(j_half.config["crop"]["pts_src"]))
    img = _smooth_image(h // 2, w // 2)
    j_out = np.asarray(j_half.correct_array(jnp.asarray(img)))
    t_out = t_half.correct_array(torch.from_numpy(img)).numpy()
    assert np.abs(t_out - j_out).mean() <= FLOAT_MEAN_TOL


def test_curvature_save_load_bumps_fusion_version(tmp_path):
    cfg = _curvature_config(48, 64)
    t = dt.CurvatureCorrection(config=cfg)
    t.pullback_field((48, 64), CPU)
    version = t._fusion_version
    da.CurvatureCorrection(config=cfg | {"bulge": {"vertical_bulge": 4e-6}}).save(tmp_path / "c")
    t.load(tmp_path / "c.npz")
    assert t.config["bulge"]["vertical_bulge"] == 4e-6 and t.cache == {}
    t.pullback_field((48, 64), CPU)
    assert t._fusion_version == version + 1


# --------------------------------------------------------------- box


def test_box_helpers_against_jax():
    voxels = np.array([[5, 9], [20, 3], [14, 30]])
    for kw in ({}, {"padding": 4}, {"padding": 4, "max_size": [22, 31]}):
        assert box.bounding_box(voxels, **kw) == jax_box.bounding_box(voxels, **kw)
    sl = (slice(2, 10), slice(3, 8))
    assert np.array_equal(box.bounding_box_inverse(sl), jax_box.bounding_box_inverse(sl))
    sl3 = (slice(0, 2), slice(1, 3), slice(2, 4))
    assert np.array_equal(box.bounding_box_inverse(sl3), jax_box.bounding_box_inverse(sl3))
    assert box.perimeter(sl) == jax_box.perimeter(sl) == 26
    assert box.perimeter(voxels) == jax_box.perimeter(voxels)
    a = box.random_patches((50, 60), 8, 5, np.random.default_rng(1))
    b = jax_box.random_patches((50, 60), 8, 5, np.random.default_rng(1))
    assert a == b
