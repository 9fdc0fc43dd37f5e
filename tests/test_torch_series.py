"""Series corrections, series and cleaning-filter concentration, and the
interpolant after a pipeline frame, against the JAX package.

The scene of ``tests/test_torch_pipeline.py`` (96x128 uint8 RGB, translation
+ curvature chain, 2x2 registration patches, 5 Jacobi sweeps), built with
the same configs in both packages, on the CPU, where both warp with the
exact gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import META, _base_u8, _objects

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.corrections.base import BaseCorrection
from darsia_tpu_torch.corrections.fuse import fused_chain

torch.set_num_threads(1)

CPU = torch.device("cpu")
T = 3


@pytest.fixture(scope="module")
def scene():
    base_u8 = _base_u8()
    frames = [np.roll(base_u8, shift=(1 + k, 3 - k), axis=(0, 1)) for k in range(T)]
    return {
        "base_u8": base_u8,
        "series": np.stack(frames, axis=2),
        "jax": _objects(da, JaxJacobi, base_u8, jnp.asarray),
        "torch": _objects(dt, dt.Jacobi, base_u8, torch.from_numpy),
    }


def _series_meta():
    return {"series": True, "time": [0.0, 30.0, 60.0], **META}


def test_series_correction_against_jax(scene):
    j, t, series = scene["jax"], scene["torch"], scene["series"]
    j_img = da.OpticalImage(
        jnp.asarray(series), transformations=[j["trans"], j["curv"]], **_series_meta()
    )
    t_img = dt.OpticalImage(
        torch.from_numpy(series), transformations=[t["trans"], t["curv"]], **_series_meta()
    )
    assert t_img.series and t_img.time == j_img.time and t_img.img.dtype == torch.uint8
    assert t_img.img.shape == tuple(j_img.img.shape) and t_img.img.shape[2] == T
    # uint8 outputs round: equal, as the single frames are (test_torch_pipeline.py).
    assert np.array_equal(t_img.img.numpy(), np.asarray(j_img.img))
    assert np.allclose(t_img.dimensions, j_img.dimensions)
    for k in range(T):
        single = dt.OpticalImage(
            torch.from_numpy(np.ascontiguousarray(series[:, :, k])),
            transformations=[t["trans"], t["curv"]],
            **META,
        )
        assert torch.equal(t_img.img[:, :, k], single.img)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_folded_series_warp_equals_frame_loop(scene, dtype):
    """One warp with the frames folded into the channels == a warp per frame."""
    t, series = scene["torch"], torch.from_numpy(scene["series"])
    if dtype == torch.float32:
        series = series.to(torch.float32) / 255.0
    chain = fused_chain([t["trans"], t["curv"]], series.shape[:2], CPU)
    folded = chain.correct_series_array(series, 2)
    looped = BaseCorrection.correct_series_array(chain, series, 2)
    assert folded.dtype == dtype and torch.equal(folded, looped)
    scalar = series[..., 0]
    assert torch.equal(chain.correct_series_array(scalar, 2), BaseCorrection.correct_series_array(chain, scalar, 2))


def test_unfused_series_correction_against_jax(scene):
    """A lone correction takes the base class' frame loop (JAX: vmap)."""
    series = scene["series"].astype(np.float32) / 255.0
    j_img = da.OpticalImage(jnp.asarray(series), transformations=[da.TranslationCorrection([1.5, -2.0])], **_series_meta())
    t_img = dt.OpticalImage(torch.from_numpy(series), transformations=[dt.TranslationCorrection([1.5, -2.0])], **_series_meta())
    assert np.abs(t_img.img.numpy() - np.asarray(j_img.img)).max() <= 1e-6


# ---------------------------------------------------------- concentration


def test_series_concentration_against_jax(scene):
    """The corrected series (equal in both packages, above) concentrated."""
    j, t = scene["jax"], scene["torch"]
    j_img = da.OpticalImage(
        jnp.asarray(scene["series"]), transformations=[j["trans"], j["curv"]], **_series_meta()
    ).img_as(np.float32)
    t_img = dt.OpticalImage(
        torch.from_numpy(scene["series"]), transformations=[t["trans"], t["curv"]], **_series_meta()
    ).img_as(torch.float32)
    j_out, t_out = j["analysis"](j_img), t["analysis"](t_img)
    assert isinstance(t_out, dt.ScalarImage) and t_out.series
    assert t_out.img.shape == tuple(j_out.img.shape) == t_img.shape[:3]
    assert t_out.time == j_out.time
    # The tolerance the single frame is held to (test_torch_pipeline.py).
    assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= 1e-4
    for k in range(T):
        frame = dt.OpticalImage(t_img.img[:, :, k].contiguous(), **t_img.metadata() | {"series": False, "time": None})
        assert torch.equal(t_out.img[..., k], t["analysis"](frame).img)


def _cleaning_analysis(pkg, jacobi, scene, as_input):
    """The scene's analysis on the raw baseline plus 2 rolled extra baselines."""
    f32 = np.float32 if pkg is da else torch.float32
    extras = [
        pkg.OpticalImage(as_input(np.roll(scene["base_u8"], s, axis=(0, 1))), **META).img_as(f32)
        for s in ((0, 1), (1, 0))
    ]
    base = pkg.OpticalImage(as_input(scene["base_u8"]), **META).img_as(f32)
    return pkg.ConcentrationAnalysis(
        base=[base] + extras,
        signal_reduction=pkg.MonochromaticReduction(color="gray"),
        restoration=lambda s: pkg.H1_regularization(s, mu=1.0, omega=0.2, dim=2, solver=jacobi(maxiter=5)),
        model=pkg.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )


def test_cleaning_filter_against_jax(scene, tmp_path):
    j_ca = _cleaning_analysis(da, JaxJacobi, scene, jnp.asarray)
    t_ca = _cleaning_analysis(dt, dt.Jacobi, scene, torch.from_numpy)
    j_filter = np.asarray(j_ca.threshold_cleaning_filter)
    t_filter = t_ca.threshold_cleaning_filter
    assert t_filter.shape == (96, 128) and float(t_filter.max()) > 0
    assert np.abs(t_filter.numpy() - j_filter).max() <= 1e-6
    probe = np.roll(scene["base_u8"], (2, 1), axis=(0, 1)).astype(np.float32) / 255.0
    j_conc = np.asarray(j_ca(da.OpticalImage(jnp.asarray(probe), **META)).img)
    t_conc = t_ca(dt.OpticalImage(torch.from_numpy(probe), **META)).img.numpy()
    assert np.abs(t_conc - j_conc).max() <= 1e-4
    # The filter changes the result: without it the concentration differs.
    plain = dt.ConcentrationAnalysis(
        base=t_ca.base, signal_reduction=t_ca.signal_reduction, restoration=t_ca.restoration,
        model=t_ca.model, **{"diff option": "positive"},
    )
    assert plain.threshold_cleaning_filter is None
    assert not np.allclose(plain(dt.OpticalImage(torch.from_numpy(probe), **META)).img.numpy(), t_conc)

    # .npy round trip, and a filter of another shape resized (linear) as JAX does.
    path = tmp_path / "filter.npy"
    t_ca.write_cleaning_filter_to_file(path)
    plain.read_cleaning_filter_from_file(path)
    assert torch.equal(plain.threshold_cleaning_filter, t_filter)
    small = tmp_path / "small.npy"
    np.save(small, j_filter[::2, ::3].copy())
    j_ca.read_cleaning_filter_from_file(small)
    t_ca.read_cleaning_filter_from_file(small)
    assert t_ca.threshold_cleaning_filter.shape == (96, 128)
    assert np.abs(t_ca.threshold_cleaning_filter.numpy() - np.asarray(j_ca.threshold_cleaning_filter)).max() <= 1e-6


def test_series_with_cleaning_filter_against_jax(scene):
    j_ca = _cleaning_analysis(da, JaxJacobi, scene, jnp.asarray)
    t_ca = _cleaning_analysis(dt, dt.Jacobi, scene, torch.from_numpy)
    series = scene["series"].astype(np.float32) / 255.0
    j_out = j_ca(da.OpticalImage(jnp.asarray(series), **_series_meta()))
    t_out = t_ca(dt.OpticalImage(torch.from_numpy(series), **_series_meta()))
    assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= 1e-4


def test_update_baseline(scene):
    t = scene["torch"]
    ca = t["analysis"]
    old = ca.base
    new = dt.OpticalImage(torch.from_numpy(scene["base_u8"]), **META)
    try:
        ca.update(base=new, mask=torch.zeros((96, 128), dtype=torch.bool))
        assert ca.base.img.dtype == torch.float32 and ca.base.img.shape == (96, 128, 3)
        assert not ca.mask.any()
    finally:
        ca.base = old


# ------------------------------------------- the interpolant after a frame


@pytest.mark.parametrize("single_warp", [False, True])
def test_displacement_after_pipeline_frame(scene, single_warp):
    """The staged shifts of a pipeline frame feed the flexible interpolant:
    ``registration.displacement()`` equals the flexible field built from the
    same shifts, and JAX's within its float32 interpolant error (see
    tests/test_torch_registration.py) plus the FFT shift spread."""
    j, t = scene["jax"], scene["torch"]
    probe = np.roll(scene["base_u8"], shift=(1, 2), axis=(0, 1))
    kw = {"transformations": [t["trans"], t["curv"]], "registration": t["registration"], "single_warp": single_warp}
    t_pipe = dt.FusedAnalysisPipeline(**kw)
    j_pipe = da.FusedAnalysisPipeline(
        transformations=[j["trans"], j["curv"]], registration=j["registration"], single_warp=single_warp
    )
    t_pipe(torch.from_numpy(probe))
    j_pipe(jnp.asarray(probe))
    ta = t_pipe._translation_analysis
    shifts, quality, centers = ta._pending_shifts
    field = t["registration"].displacement()
    assert ta._pending_shifts is None and field.shape == (2,) + tuple(t["base"].num_voxels)
    fresh = dt.TranslationAnalysis(t["base"], N_patches=[2, 2], rel_overlap=0.2, quality_tol=0.01)
    fresh._ingest_shifts(shifts.numpy(), quality.numpy(), centers)
    assert (fresh.displacement_field(tuple(t["base"].num_voxels)) - field).abs().max() <= 1e-5
    j_field = np.asarray(j["registration"].displacement())
    assert np.abs(field.numpy() - j_field).max() <= 5e-3
    pts = np.array([[60.0, 40.0]])
    assert np.abs(t["registration"].evaluate(pts, "pixel") - j["registration"].evaluate(pts, "pixel")).max() <= 5e-3
