"""The single-warp and series lanes of the port's pipeline against the JAX package.

The scene is the one of ``tests/test_torch_pipeline.py`` (96x128 uint8 RGB,
translation + curvature chain, 2x2 registration patches, 5 Jacobi sweeps),
built with the same configs in both packages.  On the CPU both packages warp
with the exact gather, so they agree to float rounding, apart from pixels
that one package's ``mode="constant"`` mask fills.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import META, _base_u8, _objects

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.convert import operands_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
T = 3
#: Pixels out of reach of the border: a one-sided mask fill (below) happens
#: only there, and the scene's 5 Jacobi sweeps (a 5-point stencil each) carry
#: its effect on the concentration 5 pixels inward.
INNER = (slice(6, -6), slice(6, -6))


def _pipes(pkg, objs):
    """``{single_warp: (with analysis, registration only)}`` pipelines on the
    scene's objects."""
    lanes = {}
    for single_warp in (False, True):
        common = {
            "transformations": [objs["trans"], objs["curv"]],
            "registration": objs["registration"],
            "single_warp": single_warp,
        }
        lanes[single_warp] = (
            pkg.FusedAnalysisPipeline(analysis=objs["analysis"], **common),
            pkg.FusedAnalysisPipeline(**common),
        )
    return lanes


def _series(base_u8):
    """(H, W, T, C) frames rolled by (1 + k, 3 - k).

    On these frames the two packages' patch shifts agree to rounding.  On
    others of the scene the subpixel fits of the two FFT libraries part by
    up to 1.5e-3 px (tests/test_torch_pipeline.py bounds shifts at 1e-3),
    and the two-warp lane may fill a border pixel at a TPS boundary point in
    one package only: the frame then differs by ~1e-5 on average and by
    ~2e-2 next to that pixel, beyond the series tolerances below.
    """
    frames = [np.roll(base_u8, shift=(1 + k, 3 - k), axis=(0, 1)) for k in range(T)]
    return np.stack(frames, axis=2)


def _blob_probe(probe):
    """bench.py's synthetic tracer blob, scaled from 1788x3180 to the scene."""
    H, W = probe.shape[:2]
    yy, xx = np.ogrid[:H, :W]
    sy, sx = 160.0 * H / 1788, 260.0 * W / 3180
    blob = 40.0 * np.exp(-(((yy - H * 0.6) / sy) ** 2 + ((xx - W * 0.4) / sx) ** 2))
    blob_probe = np.clip(probe.astype(np.int32) + blob[..., None], 0, 255)
    return blob, blob_probe.astype(np.uint8)


def _blob_gate(blob, conc_two_warp, conc_one_warp):
    """(blob_rel_err, noise_ratio) of bench.py:213-230."""
    bmask = (blob > 4.0)[: conc_two_warp.shape[0], : conc_two_warp.shape[1]]
    staged = float(conc_two_warp[bmask].sum())
    one = float(conc_one_warp[bmask].sum())
    rel_err = abs(one - staged) / max(abs(staged), 1e-12)
    noise = float(conc_one_warp[~bmask].mean()) / max(
        float(conc_two_warp[~bmask].mean()), 1e-12
    )
    return rel_err, noise


@pytest.fixture(scope="module")
def scene():
    base_u8 = _base_u8()
    j = _objects(da, JaxJacobi, base_u8, jnp.asarray)
    t = _objects(dt, dt.Jacobi, base_u8, torch.from_numpy)
    return {
        "base_u8": base_u8,
        "probe": np.roll(base_u8, shift=(1, 2), axis=(0, 1)),
        "jax": j,
        "torch": t,
        "jax_lanes": _pipes(da, j),
        "torch_lanes": _pipes(dt, t),
    }


def _one_sided_fills(j_reg, t_reg):
    """Pixels of the registered frame that only one package's
    ``mode="constant"`` mask fills (all channels 0).

    On the border, a sample position within rounding of the domain edge
    (zero TPS displacement at a boundary point, evaluated by two matvec
    libraries) can land on either side of the mask; tests/
    test_torch_pipeline.py allows such pixels too.  Every other pixel must
    agree to rounding.
    """
    off = (np.abs(j_reg - t_reg) > 1e-5).any(axis=-1)
    assert off.sum() <= 4
    for p in zip(*np.nonzero(off)):
        assert (j_reg[p] == 0).all() or (t_reg[p] == 0).all()
    return off


def test_single_warp_registered_image_matches_jax(scene):
    probe = scene["probe"]
    j_pipe, t_pipe = scene["jax_lanes"][True][1], scene["torch_lanes"][True][1]
    j_reg = np.asarray(j_pipe(da.OpticalImage(jnp.asarray(probe), **META)).img)
    t_out = t_pipe(dt.OpticalImage(torch.from_numpy(probe), **META))
    assert isinstance(t_out, dt.OpticalImage)
    t_reg = t_out.img.numpy()
    assert t_reg.shape == j_reg.shape == tuple(scene["torch"]["base"].shape)
    off = _one_sided_fills(j_reg, t_reg)
    assert np.abs(t_reg - j_reg)[~off].max() <= 1e-4


def test_single_warp_concentration_matches_jax(scene):
    probe = scene["probe"]
    j_pipe, t_pipe = scene["jax_lanes"][True][0], scene["torch_lanes"][True][0]
    j_conc = np.asarray(j_pipe(da.OpticalImage(jnp.asarray(probe), **META)).img)
    t_out = t_pipe(dt.OpticalImage(torch.from_numpy(probe), **META))
    assert isinstance(t_out, dt.ScalarImage)
    tc = t_out.img.numpy()
    assert tc.shape == j_conc.shape and np.isfinite(tc).all()
    d = np.abs(tc - j_conc)
    assert d[INNER].max() <= 1e-4
    assert float((d > 1e-4).mean()) <= 5e-3


def test_single_warp_against_two_warp_lane(scene):
    """The JAX package's own tolerances between its two lanes
    (tests/unit/test_fusedpipeline.py:188-209), held on the port."""
    t, probe = scene["torch"], torch.from_numpy(scene["probe"])
    ref = scene["torch_lanes"][False][1](probe).img.numpy()[INNER]
    one = scene["torch_lanes"][True][1](probe).img.numpy()[INNER]
    assert np.abs(ref - one).mean() < 3e-2
    base = t["base"].img.numpy()[INNER]
    assert np.abs(one - base).mean() < 1.2 * np.abs(ref - base).mean() + 1e-3
    conc_ref = t["pipe"](probe).img.numpy()[INNER]
    conc_one = scene["torch_lanes"][True][0](probe).img.numpy()[INNER]
    assert np.abs(conc_ref - conc_one).mean() < 1.5e-2


def test_single_warp_needs_registration_and_chain(scene):
    t = scene["torch"]
    pipe = dt.FusedAnalysisPipeline(
        transformations=[t["trans"], t["curv"]], single_warp=True
    )
    with pytest.raises(ValueError, match="single_warp"):
        pipe(torch.from_numpy(scene["probe"]))
    pipe = dt.FusedAnalysisPipeline(registration=t["registration"], single_warp=True)
    with pytest.raises(ValueError, match="single_warp"):
        pipe(torch.from_numpy(scene["probe"]))


def test_single_warp_setup_products_and_jax_operands(scene):
    shape = scene["probe"].shape[:2]
    j_pipe, t_pipe = scene["jax_lanes"][True][0], scene["torch_lanes"][True][0]
    _, j_ops = j_pipe._build(shape, np.uint8, False)
    _, t_ops = t_pipe._build(shape, torch.uint8, CPU)
    assert set(t_ops) == set(j_ops) == {"field_0", "reg", "base", "coarse_pos"}
    assert np.array_equal(t_ops["coarse_pos"].numpy(), np.asarray(j_ops["coarse_pos"]))
    numpy_ops = {k: np.asarray(v) for k, v in j_ops.items() if k != "reg"}
    numpy_ops["reg"] = {k: np.asarray(v) for k, v in j_ops["reg"].items()}
    probe = scene["probe"]
    out = t_pipe(torch.from_numpy(probe), operands=operands_from_numpy(numpy_ops, CPU))
    own = t_pipe(torch.from_numpy(probe))
    assert np.abs(out.img.numpy() - own.img.numpy()).max() <= 1e-4


def test_blob_gate_on_both_packages(scene):
    """bench.py's single-warp blob gate on the same input in both packages:
    a gap on the port's side shows apart from the reference's own drift."""
    blob, blob_probe = _blob_probe(scene["probe"])
    j, t = scene["jax"], scene["torch"]
    j_two = np.asarray(j["pipe"](jnp.asarray(blob_probe)).img)
    j_one = np.asarray(scene["jax_lanes"][True][0](jnp.asarray(blob_probe)).img)
    t_two = t["pipe"](torch.from_numpy(blob_probe)).img.numpy()
    t_one = scene["torch_lanes"][True][0](torch.from_numpy(blob_probe)).img.numpy()
    j_err, j_noise = _blob_gate(blob, j_two, j_one)
    t_err, t_noise = _blob_gate(blob, t_two, t_one)
    print(
        f"blob gate, 96x128 scene: jax blob_rel_err={j_err} noise_ratio={j_noise}; "
        f"torch blob_rel_err={t_err} noise_ratio={t_noise}"
    )
    # At this scale the blob error exceeds the 4K gate of 5e-2 in both
    # packages alike; the gate itself is held at 4K on the card.
    assert abs(t_err - j_err) <= 1e-3
    assert abs(t_noise - j_noise) <= 1e-3


@pytest.mark.parametrize("single_warp", [False, True])
def test_series_matches_jax_and_single_frames(scene, single_warp):
    series = _series(scene["base_u8"])
    j_pipe = scene["jax_lanes"][single_warp][0]
    t_pipe = scene["torch_lanes"][single_warp][0]
    times = [0.0, 30.0, 60.0]
    meta = {"series": True, "time": times, **META}
    j_out = j_pipe(da.OpticalImage(jnp.asarray(series), **meta))
    t_out = t_pipe(dt.OpticalImage(torch.from_numpy(series), **meta))
    assert t_out.series and isinstance(t_out, dt.ScalarImage)
    assert t_out.time == times and t_out.time_num == T
    jr, tr = np.asarray(j_out.img), t_out.img.numpy()
    assert tr.shape == jr.shape and tr.shape[-1] == T
    for k in range(T):
        # The JAX package's own tolerances between its series and its
        # single frames (tests/unit/test_fusedpipeline.py:146-155).
        d = np.abs(tr[..., k] - jr[..., k])
        assert float(d.mean()) <= 1e-5
        assert float((d > 1e-3).mean()) <= 5e-3
        assert float(d.max()) <= 8e-3
        single = t_pipe(torch.from_numpy(np.ascontiguousarray(series[:, :, k]))).img
        assert torch.equal(t_out.img[..., k], single)
    # A raw (H, W, T, C) array is a series too.
    raw = t_pipe(torch.from_numpy(series))
    assert raw.series and torch.equal(raw.img, t_out.img)


def test_series_image_metadata_matches_jax():
    from datetime import datetime, timedelta

    arr = np.random.default_rng(3).random((6, 8, 4, 3)).astype(np.float32)
    start = datetime(2023, 5, 1, 12, 0, 0)
    dates = [start + timedelta(seconds=45 * k) for k in range(4)]
    meta = {"series": True, "date": dates, "width": 2.0, "height": 1.5}
    j = da.OpticalImage(arr, **meta)
    t = dt.OpticalImage(arr, device="cpu", **meta)
    assert t.series and t.time_num == j.time_num == 4
    assert t.time == j.time == [0.0, 45.0, 90.0, 135.0]
    jm, tm = j.metadata(), t.metadata()
    assert set(tm) == set(jm)
    for key in jm:
        assert np.array_equal(np.asarray(tm[key]), np.asarray(jm[key])), key
    js, ts = j.time_slice(2), t.time_slice(2)
    assert not ts.series and ts.time == js.time == 90.0 and ts.date == js.date
    assert np.array_equal(ts.img.numpy(), np.asarray(js.img))
    scalar = dt.ScalarImage(arr[..., 0], series=True, time=[0, 1, 2, 3], device="cpu")
    assert scalar.time_slice(1).img.shape == (6, 8)
    # Corrections of a series correct every frame.
    t_corr = dt.OpticalImage(
        arr, device="cpu", transformations=[dt.TranslationCorrection([1, 0])], **meta
    )
    j_corr = da.OpticalImage(arr, transformations=[da.TranslationCorrection([1, 0])], **meta)
    assert t_corr.series and t_corr.time == j_corr.time
    assert np.abs(t_corr.img.numpy() - np.asarray(j_corr.img)).max() <= 1e-6
