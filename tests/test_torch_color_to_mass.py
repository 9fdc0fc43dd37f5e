"""Parity of the port's heterogeneous colour-to-mass analysis with the JAX
package, on the CPU.

The same seeded numpy inputs go through ``darsia_tpu`` and
``darsia_tpu_torch``: per-label models, the clip and piecewise-linear
signal functions, the flashes, the CO2 mass analyses, the expert-knowledge
adapter, the whole chain on ``tests/unit/test_color_to_mass.py``'s 48x64
scene (every stage and the integrated mass), its Nelder-Mead calibration,
and calibration folders written by one package and read by the other.

Tolerances: float32 maps agree within ``ATOL`` = 1e-6 (absolute, on values
of order 1), maps in kg/m^3 within ``RTOL`` = 1e-6 relative to the map's
largest value: each step is the same float32 op in both libraries, which
may round its last bit differently (XLA contracts some multiply-adds on the
CPU; PyTorch does not).  Integrated masses (float64 sums of those maps) agree
within 1e-6 relative.  The calibrated masses of the two packages agree
within 1e-2 relative (Nelder-Mead may take another simplex path on a
last-bit difference of the objective).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

ATOL = 1e-6
RTOL = 1e-6
H, W = 48, 64
META = {"width": 2.0, "height": 1.0}


def np_of(x) -> np.ndarray:
    x = x.img if hasattr(x, "img") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(port, jax_out, atol=ATOL) -> float:
    a, b = np_of(port), np_of(jax_out)
    assert a.shape == b.shape
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= atol, err
    return err


def close_rel(port, jax_out, rtol=RTOL) -> float:
    b = np_of(jax_out).astype(np.float64)
    return close(port, b, atol=rtol * max(np.abs(b).max(), 1e-30))


def as_input(pkg, arr):
    return torch.from_numpy(np.ascontiguousarray(arr)) if pkg is dt else arr


# ------------------------------------------------------------------ scene


def _arrays() -> dict:
    """The 48x64 scene of tests/unit/test_color_to_mass.py."""
    labels = np.zeros((H, W), np.int32)
    labels[:, 32:] = 1
    base = np.full((H, W, 3), 0.5, np.float32)
    img = base.copy()
    img[10:30, 5:25] += [0.3, -0.1, -0.1]
    img[10:30, 40:60] += [0.15, -0.05, -0.05]
    return {"labels": labels, "base": base, "img": np.clip(img, 0, 1)}


def build_chain(pkg, arrays=None, adapter_rois=None):
    """(chain, image, geometry) of the scene in ``pkg``."""
    arrays = arrays or _arrays()
    labels_img = pkg.Image(as_input(pkg, arrays["labels"]), scalar=True, **META)
    baseline = pkg.Image(as_input(pkg, arrays["base"]), color_space="RGB", **META)
    img = pkg.Image(as_input(pkg, arrays["img"]), color_space="RGB", **META)
    img.time = 3600.0
    relative = {0: [0.3, -0.1, -0.1], 1: [0.15, -0.05, -0.05]}
    interp = {
        k: pkg.ColorPathInterpolation(
            pkg.ColorPath(relative_colors=[np.zeros(3), np.array(v)], base_color=np.full(3, 0.5)),
            pkg.ColorMode.RELATIVE,
            values=[0, 1],
        )
        for k, v in relative.items()
    }
    sig = {k: pkg.PWTransformation(supports=[0, 0.5, 1], values=[0, 0.4, 1]) for k in relative}
    flash = pkg.SimpleFlash(0.05, 0.5, 0.5, 1.0)
    mass = pkg.CO2MassAnalysis(baseline, atmospheric_pressure=1.01, atmospheric_temperature=22.0)
    field = {"width": 2.0, "height": 1.0, "scalar": True}
    depth = pkg.Image(as_input(pkg, np.full((H, W), 0.02, np.float32)), **field)
    porosity = pkg.Image(as_input(pkg, np.full((H, W), 0.44, np.float32)), **field)
    geom = pkg.ExtrudedPorousGeometry(porosity=porosity, depth=depth, **baseline.shape_metadata())
    adapter = None if adapter_rois is None else pkg.ExpertKnowledgeAdapter(**adapter_rois)
    chain = pkg.HeterogeneousColorToMassAnalysis(
        baseline=baseline,
        labels=labels_img,
        color_mode=pkg.ColorMode.RELATIVE,
        color_path_interpretation=interp,
        signal_functions=sig,
        flash=flash,
        co2_mass_analysis=mass,
        geometry=geom,
        expert_knowledge_adapter=adapter,
    )
    return chain, img, geom


class Protocol:
    def injected_mass(self, date=None, time=None):
        return 0.002


EXPERIMENT = SimpleNamespace(injection_protocol=Protocol())
LEFT_HALF = {"saturation_g_rois": {"left": SimpleNamespace(roi=np.array([[0.0, 0.0], [1.0, 1.0]]))}}


@pytest.fixture(scope="module")
def jax_calibrated():
    """The JAX chain after ``automatic_calibration(maxiter=40)``: its flash
    bounds, signal values and integrated mass."""
    chain, img, geom = build_chain(da)
    # The pH stage's eager path (the one the JAX colour stage always takes):
    # its jitted path would be traced anew at each of the ~60 evaluations.
    chain.signal_model._fused = False
    before = float(geom.integrate(chain(img).mass))
    chain.automatic_calibration([img], EXPERIMENT, maxiter=40)
    return {
        "before": before,
        "after": float(geom.integrate(chain(img).mass)),
        "flash": chain.flash.to_dict(),
    }


# ------------------------------------------------------------------ the chain


@pytest.mark.parametrize("rois", [None, LEFT_HALF], ids=["plain", "gas ROI"])
def test_chain_stages_against_jax(rois):
    """Every stage of the chain and the integrated masses."""
    (jc, jimg, jgeom), (tc, timg, tgeom) = (build_chain(pkg, adapter_rois=rois) for pkg in (da, dt))
    ci_j, ci_t = jc.call_color_interpretation(jimg), tc.call_color_interpretation(timg)
    close(ci_t, ci_j)
    ph_j, ph_t = jc.call_pH_analysis(ci_j), tc.call_pH_analysis(ci_t)
    close(ph_t, ph_j)
    res_j, res_t = jc.call_flash_and_mass_analysis(ph_j), tc.call_flash_and_mass_analysis(ph_t)
    for key in ("saturation_g", "concentration_aq"):
        close(getattr(res_t, key), getattr(res_j, key))
    for key in ("mass", "mass_g", "mass_aq"):
        close_rel(getattr(res_t, key), getattr(res_j, key))
        m_j, m_t = jgeom.integrate(getattr(res_j, key)), tgeom.integrate(getattr(res_t, key))
        assert abs(m_t - m_j) <= 1e-6 * abs(m_j)
    assert isinstance(ci_t, dt.ScalarImage) and ci_t.img.dtype == torch.float32
    assert res_t.mass.img.device.type == "cpu" and res_t.time == 3600.0
    # The unit test's own checks hold in the port.
    ci = ci_t.img.numpy()
    assert ci[20, 15] == pytest.approx(1.0, abs=0.02) and ci[2, 2] == pytest.approx(0.0, abs=0.02)
    if rois is not None:
        sg = res_t.saturation_g.img.numpy()
        assert np.abs(sg[:, 32:]).max() == 0.0 and sg[20, 15] > 0.5


def test_automatic_calibration_against_jax(jax_calibrated):
    chain, img, geom = build_chain(dt)
    before = float(geom.integrate(chain(img).mass))
    assert before == pytest.approx(jax_calibrated["before"], rel=1e-6)
    chain.automatic_calibration([img], EXPERIMENT, maxiter=40)
    after = float(geom.integrate(chain(img).mass))
    # The JAX test's own bounds (tests/unit/test_color_to_mass.py:117-121).
    assert abs(after - 0.002) < abs(before - 0.002)
    assert abs(after - 0.002) / 0.002 < 0.2
    assert after == pytest.approx(jax_calibrated["after"], rel=1e-2)


def test_manual_calibration_session(tmp_path):
    chain, img, geom = build_chain(dt)
    session = chain.manual_calibration_session([img], EXPERIMENT, log=tmp_path / "log")
    first = session.propose()
    old = np.asarray(chain.signal_model.model[1][0].values)
    moved = session.propose(signal_values={0: old * 1.2}, flash_bounds={"max_value_g": 3.0})
    np.testing.assert_allclose(chain.signal_model.model[1][0].values, old * 1.2)
    assert chain.flash.max_value_g == 3.0 and len(session.iterations) == 2
    assert session.preview()["detected_mass"].shape == (1,) and moved["error"] != first["error"]
    assert session.preview(path=tmp_path / "preview.png")["detected_mass"].shape == (1,)
    assert (tmp_path / "preview.png").stat().st_size > 0
    assert session.accept() is chain
    assert (tmp_path / "log" / "calibration_log.npz").exists()
    assert (tmp_path / "log" / "calibrated" / "flash.npz").exists()


# ------------------------------------------------------------------ folders


def _perturbed(pkg):
    """The scene's chain with non-trivial flash bounds and signal values."""
    chain, img, geom = build_chain(pkg)
    chain.update_flash(min_value_aq=0.07, max_value_aq=0.55, min_value_g=0.45, max_value_g=0.9)
    chain.update_signal_function(1, values=[0.0, 0.3, 0.95])
    return chain, img, geom


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_folder_round_trip(tmp_path, writer):
    """A folder one package writes gives the same mass in the other, through
    ``from_folder`` and ``load`` (the CSV through pandas on the JAX side)."""
    import pandas as pd

    packages = {"jax": da, "port": dt}
    src_pkg = packages[writer]
    dst_pkg = packages["port" if writer == "jax" else "jax"]
    src, src_img, src_geom = _perturbed(src_pkg)
    src.save(tmp_path / "c2m")
    frame = pd.read_csv(tmp_path / "c2m" / "signal_function_1.csv")
    assert list(frame.columns) == ["supports", "values"] and frame["values"].tolist() == [0.0, 0.3, 0.95]
    want = src_geom.integrate(src(src_img).mass)

    fresh, img, geom = build_chain(dst_pkg)
    loaded = dst_pkg.HeterogeneousColorToMassAnalysis.from_folder(
        tmp_path / "c2m", baseline=fresh.color_analysis.base, labels=fresh.labels,
        co2_mass_analysis=fresh.co2_mass_analysis, geometry=geom,
    )
    assert loaded.flash.to_dict() == src.flash.to_dict()
    assert geom.integrate(loaded(img).mass) == pytest.approx(want, rel=1e-6)
    fresh.load(tmp_path / "c2m")
    assert geom.integrate(fresh(img).mass) == pytest.approx(want, rel=1e-6)


def test_from_folder_without_flash_and_empty(tmp_path):
    chain, img, geom = build_chain(dt)
    chain.save(tmp_path / "c2m")
    (tmp_path / "c2m" / "flash.npz").unlink()
    loaded = dt.HeterogeneousColorToMassAnalysis.from_folder(
        tmp_path / "c2m", chain.color_analysis.base, chain.labels, chain.co2_mass_analysis, geom
    )
    assert loaded.flash.to_dict() == dt.SimpleFlash(0.0, 1.0, 1.0, 2.0).to_dict()
    with pytest.raises(FileNotFoundError):
        chain.load(tmp_path / "c2m")
    with pytest.raises(FileNotFoundError, match="No calibrated"):
        dt.HeterogeneousColorToMassAnalysis.from_folder(
            tmp_path / "empty", chain.color_analysis.base, chain.labels, chain.co2_mass_analysis, geom
        )


def test_chain_parts_from_calibration_against_jax():
    """The conversion builds parts that evaluate as the JAX objects do."""
    rng = np.random.default_rng(3)
    colors = np.cumsum(rng.random((4, 3)) * 0.2, axis=0)
    path = da.ColorPath(colors=list(colors), base_color=colors[0], mode="rgb")
    jax_interp = da.ColorPathInterpolation(path, da.ColorMode.ABSOLUTE, values=[0, 0.2, 0.7, 1.0])
    jax_pw = da.PWTransformation(supports=[0, 0.3, 1], values=[0, 0.5, 2])
    calibration = {
        "color_paths": {"2": {**path.to_dict(), "color_mode": "absolute", "values": [0, 0.2, 0.7, 1.0]}},
        "signal_functions": {2: {"supports": [0, 0.3, 1], "values": [0, 0.5, 2]}},
        "flash": np.array([0.1, 0.6, 0.5, 1.0]),
    }
    interps, functions, flash = dt.convert.chain_parts_from_calibration(calibration)
    assert list(interps) == [2] and list(functions) == [2]
    probe = rng.random((9, 11, 3)).astype(np.float32) * 0.8
    close(interps[2].call_array(torch.from_numpy(probe)), jax_interp.call_array(probe))
    x = rng.random((9, 11)).astype(np.float32) * 1.4 - 0.2
    close(functions[2].call_array(torch.from_numpy(x)), jax_pw.call_array(x))
    assert flash.to_dict() == {"min_value_aq": 0.1, "max_value_aq": 0.6, "min_value_g": 0.5, "max_value_g": 1.0}
    assert dt.convert.chain_parts_from_calibration({"flash": None})[2] is None


# ------------------------------------------------------------------ modules


def test_heterogeneous_model_with_ignored_labels():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, (12, 16)).astype(np.int32)
    signal = rng.random((12, 16)).astype(np.float32) * 1.2 - 0.1
    outs = []
    for pkg in (da, dt):
        functions = {
            k: pkg.PWTransformation(supports=[0, 0.5, 1], values=[0, 0.1 * (k + 1), 0.5 + 0.1 * k])
            for k in (0, 1, 3)
        }
        model = pkg.HeterogeneousModel(functions, as_input(pkg, labels), ignore_labels=[1])
        assert model.unique_labels == [0, 1, 2, 3] and model.keys() == [0, 1, 3]
        outs.append(model(as_input(pkg, signal)))
    close(outs[1], outs[0])
    out = outs[1].numpy()
    assert (out[(labels == 1) | (labels == 2)] == 0).all()
    # A prototype is copied per label; the output follows the sub-model.
    clip = dt.HeterogeneousModel(dt.ClipModel(0.2, 0.6), torch.from_numpy(labels))
    assert clip.models[0] is not clip.models[1]
    close(clip.call_array(torch.from_numpy(signal)), np.clip(signal, 0.2, 0.6))


def test_heterogeneous_model_copies_labels_once_per_device():
    labels = torch.zeros((4, 5), dtype=torch.int64)
    model = dt.HeterogeneousModel(dt.ClipModel(0.0, 1.0), labels)
    assert model.labels_on("cpu") is labels
    assert model.labels_on(torch.device("cpu")) is model.labels_on("cpu")


@pytest.mark.parametrize("bounds", [(0.1, 0.7), (None, 0.5), (0.3, None)])
def test_clip_model_against_jax(bounds):
    x = np.linspace(-1, 2, 50, dtype=np.float32).reshape(5, 10)
    close(dt.ClipModel(*bounds)(torch.from_numpy(x)), da.ClipModel(*bounds)(x))
    model = dt.ClipModel(key="c", c_min_value=0.0, c_max_value=1.0)
    model.update_model_parameters([0.2], dofs=["min_value"])
    assert (model._min_value, model._max_value) == (0.2, 1.0)
    with pytest.raises(ValueError):
        dt.ClipModel()


def test_pw_transformation_and_inverse_against_jax(tmp_path):
    supports, values = [-0.5, 0, 0.25, 0.25, 1.0, 3.0], [0, 0, 0.1, 0.3, 1.2, 2.0]
    pws = (da.PWTransformation(supports, values), dt.PWTransformation(supports, values))
    x = np.linspace(-1, 4, 201, dtype=np.float32)
    close(pws[1](torch.from_numpy(x)), pws[0](x))
    y = np.linspace(-0.5, 2.5, 31)
    np.testing.assert_array_equal(pws[1].inverse(y), pws[0].inverse(y))
    assert pws[1].inverse(0.05) == pws[0].inverse(0.05)
    # CSV both ways: the port writes the file pandas writes.
    pws[0].save(tmp_path / "jax.csv")
    pws[1].save(tmp_path / "port.csv")
    assert (tmp_path / "jax.csv").read_text() == (tmp_path / "port.csv").read_text()
    with pytest.raises(AssertionError, match="monotonicity"):
        dt.PWTransformation(supports=[0, 0.5, 1], values=[0, 0.8, 0.5])
    np.testing.assert_array_equal(pws[1].values_from_diff([1, 2]), [0, 1, 3])
    for reader, path in ((dt, "jax"), (da, "port")):
        back = reader.PWTransformation.load(tmp_path / f"{path}.csv")
        src = pws[0] if path == "jax" else pws[1]
        np.testing.assert_array_equal(back.supports, src.supports)
        np.testing.assert_array_equal(back.values, src.values)
    pws[1].update(values=[0.05], dofs=[1])
    assert pws[1].values[1] == 0.05
    close(pws[1](torch.from_numpy(x)), da.PWTransformation(supports, pws[1].values)(x))
    pws[1].log(tmp_path / "log.png")
    assert (tmp_path / "log.png").stat().st_size > 0


def test_flashes_against_jax(tmp_path):
    rng = np.random.default_rng(7)
    signal = rng.random((10, 12)).astype(np.float32) * 1.3 - 0.1
    c_g = rng.random((10, 12)).astype(np.float32)
    c_aq = rng.random((10, 12)).astype(np.float32)
    simple = [pkg.SimpleFlash(0.05, 0.5, 0.5, 1.0) for pkg in (da, dt)]
    outs = [f(pkg.ScalarImage(as_input(pkg, signal), **META)) for f, pkg in zip(simple, (da, dt))]
    for a, b in zip(outs[1], outs[0]):
        close(a, b)
    for cutoff in (0.0, 0.3):
        got = [
            pkg.AdvancedFlash(0.8, cutoff, restoration=None)(
                pkg.ScalarImage(as_input(pkg, c_g), **META), pkg.ScalarImage(as_input(pkg, c_aq), **META)
            )
            for pkg in (da, dt)
        ]
        for a, b in zip(got[1], got[0]):
            close(a, b)
    # npz both ways; to_dict / from_dict.
    simple[0].update(min_value_aq=0.02)
    simple[0].save(tmp_path / "jax_flash")
    back = dt.SimpleFlash(0, 1, 1, 2)
    back.load(tmp_path / "jax_flash.npz")
    assert back.to_dict() == simple[0].to_dict()
    back.update(max_value_g=1.5)
    back.save(tmp_path / "port_flash")
    jax_back = da.SimpleFlash(0, 1, 1, 2)
    jax_back.load(tmp_path / "port_flash.npz")
    assert jax_back.to_dict() == back.to_dict() == dt.SimpleFlash.from_dict(back.to_dict()).to_dict()


def test_co2_mass_analyses_against_jax():
    rng = np.random.default_rng(9)
    maps = {k: rng.random((H, W)).astype(np.float32) for k in ("a", "b")}
    out = {}
    for pkg in (da, dt):
        baseline = pkg.Image(as_input(pkg, np.full((H, W, 3), 0.5, np.float32)), **META)
        mass = pkg.CO2MassAnalysis(baseline, 1.01, 22.0, 0.01, 0.5)
        a, b = (pkg.ScalarImage(as_input(pkg, maps[k]), **META) for k in ("a", "b"))
        res = mass.mass_analysis(c_aq=a, s_g=b)
        inv = mass.inverse_mass_analysis(res.mass)
        out[pkg] = {
            "call": mass(a, b),
            "res": [res.mass, res.mass_g, res.mass_aq, res.saturation_aq],
            "inv": [inv.mass, inv.saturation_g, inv.concentration_aq],
            "maps": (mass.density_gaseous_co2, mass.solubility_co2, mass.hydrostatic_pressure),
        }
        mass.setup_20_degrees_celsius()
        mass.setup_23_degrees_celsius()
        out[pkg]["nist"] = mass.data_NIST_20[1] + mass.data_NIST_23[1]
    for key in ("call", "res", "inv"):
        for a, b in zip(out[dt][key], out[da][key]):
            close_rel(a, b)
    for a, b in zip(out[dt]["maps"], out[da]["maps"]):
        np.testing.assert_array_equal(a, b)
    assert out[dt]["nist"] == out[da]["nist"]


def test_co2_maps_cached_per_device_and_rebuilt_on_update():
    baseline = dt.Image(torch.zeros((6, 8, 3)), **META)
    mass = dt.CO2MassAnalysis(baseline)
    first = mass.maps_on("cpu")
    assert mass.maps_on(torch.device("cpu"))[0] is first[0] and first[0].dtype == torch.float32
    mass.update_state(atmospheric_pressure=1.2)
    again = mass.maps_on("cpu")
    assert again[0] is not first[0] and float(again[0][0, 0]) > float(first[0][0, 0])


def test_advanced_co2_mass_analysis_against_jax():
    arrays = _arrays()
    got = {}
    for pkg in (da, dt):
        baseline = pkg.Image(as_input(pkg, arrays["base"]), **META)
        img = pkg.Image(as_input(pkg, arrays["img"]), **META)
        analyses = [
            pkg.ConcentrationAnalysis(
                base=baseline,
                signal_reduction=pkg.MonochromaticReduction(color=color),
                model=pkg.LinearModel(scaling=scale),
                **{"diff option": "absolute"},
            )
            for color, scale in (("red", 4.0), ("gray", 9.0))
        ]
        advanced = pkg.AdvancedCO2MassAnalysis(
            analyses[0], analyses[1], None, pkg.Flash(0.9, 0.2), pkg.CO2MassAnalysis(baseline)
        )
        advanced.update_parameters(np.array([4.0, 0.01, 9.0, -0.01]))
        got[pkg] = advanced(img)
        assert advanced.ndofs() == 4
    for a, b in zip(got[dt], got[da]):
        close_rel(a, b)


def test_expert_knowledge_adapter_against_jax():
    rng = np.random.default_rng(11)
    data = rng.random((H, W)).astype(np.float32)
    rois = {
        "saturation_g_rois": {
            "a": SimpleNamespace(roi=np.array([[0.1, 0.2], [0.9, 0.8]])),
            "b": np.array([[1.2, 0.1], [1.9, 0.5]]),
        }
    }
    got = []
    for pkg in (da, dt):
        adapter = pkg.ExpertKnowledgeAdapter(**rois)
        image = pkg.ScalarImage(as_input(pkg, data), **META)
        got.append(adapter.apply(image, "saturation_g"))
        assert adapter.apply(image, "concentration_aq") is image and adapter.apply(None, "x") is None
    close(got[1], got[0])
    adapter = dt.ExpertKnowledgeAdapter(**rois)
    image = dt.ScalarImage(torch.from_numpy(data), **META)
    assert adapter.mask_for(image, "saturation_g") is adapter.mask_for(image, "saturation_g")
    mask = dt.roi_to_mask([rois["saturation_g_rois"]["b"]], image)
    want = np.asarray(da.roi_to_mask([rois["saturation_g_rois"]["b"]], da.ScalarImage(data, **META)).img)
    assert mask.img.dtype == torch.bool and np.array_equal(mask.img.numpy(), want)


def test_time_series_and_run_analysis(tmp_path):
    (jc, jimg, jgeom), (tc, timg, tgeom) = (build_chain(pkg) for pkg in (da, dt))
    trackers = [pkg.SimpleRunAnalysis(geom) for pkg, geom in ((da, jgeom), (dt, tgeom))]
    for tracker, chain, img in zip(trackers, (jc, tc), (jimg, timg)):
        for scale in (1.0, 0.5, 2.0):
            chain.update_flash(max_value_g=scale)
            tracker.append(chain(img), name=f"s{scale}")
    for key in ("mass", "mass_g", "mass_aq", "volume_g"):
        np.testing.assert_allclose(getattr(trackers[1].data, key), getattr(trackers[0].data, key), rtol=1e-6)
    assert trackers[1].names == ["s1.0", "s0.5", "s2.0"]
    # Reference-side fault: an ROI's subregion is integrated with the whole
    # geometry's volumes resized to it and scaled by the voxel-count ratio
    # (darsia_tpu/presets/workflows/simple_run_analysis.py:36-45 with
    # measure/integration.py:60-84), so the left half's mass comes out
    # doubled; mirrored.
    rois = [pkg.make_coordinate([[0.0, 0.0], [1.0, 1.0]]) for pkg in (da, dt)]
    parts = [t.integrated_mass(c(i), roi=r) for t, c, i, r in zip(trackers, (jc, tc), (jimg, timg), rois)]
    for key in ("mass", "mass_g", "mass_aq"):
        assert parts[1][key] == pytest.approx(parts[0][key], rel=1e-6)
    left = float((tc(timg).mass.img[:, :32].double() * np.prod(tgeom.voxel_size) * 0.44 * 0.02).sum())
    assert parts[1]["mass"] == pytest.approx(2 * left, rel=1e-6)
    trackers[1].save(tmp_path / "series")
    back = dt.MultiphaseTimeSeriesAnalysis(tgeom)
    back.load(tmp_path / "series.npz")
    assert back.data.mass == trackers[1].data.mass
    jax_back = da.MultiphaseTimeSeriesAnalysis(jgeom)
    jax_back.load(tmp_path / "series.npz")
    for tracker in (back, jax_back):
        tracker.data.mass[1] = 5.0
        tracker.clean(3.0)
    assert back.data.mass == jax_back.data.mass
    canvas = trackers[1].plot_gas(timg, timg, tc(timg), None)
    assert canvas.dtype == np.uint8 and canvas.ndim == 3 and canvas.shape[-1] == 3
    data = dt.SimpleMultiphaseTimeSeriesData()
    data.append(0.0, 1.0, 0.5, 0.5, name="a")
    data.reset()
    assert data.names == [] and data.mass == []


def test_mass_computation_against_jax():
    rng = np.random.default_rng(13)
    signal = rng.random((H, W)).astype(np.float32) * 1.2
    results = []
    for pkg in (da, dt):
        chain, img, geom = build_chain(pkg)
        from_pkg = da.presets.workflows if pkg is da else dt.presets.workflows
        mc = from_pkg.MassComputation(chain.color_analysis.base, geom, pkg.SimpleFlash(0.05, 0.5, 0.5, 1.0), chain.co2_mass_analysis)
        res = mc(pkg.ScalarImage(as_input(pkg, signal), **META))
        results.append((res.mass, mc.integrated_mass(pkg.ScalarImage(as_input(pkg, signal), **META))))
    close_rel(results[1][0], results[0][0])
    assert results[1][1] == pytest.approx(results[0][1], rel=1e-6)


# ------------------------------------------------------------------ colour analysis


def _analysis(pkg, labels, base):
    labels_img = pkg.Image(as_input(pkg, labels), scalar=True, width=1.0, height=1.0)
    baseline = pkg.Image(as_input(pkg, base), color_space="RGB", width=1.0, height=1.0)
    analysis = pkg.HeterogeneousColorAnalysis(baseline, labels_img, pkg.ColorMode.RELATIVE)
    for label, rel in ((0, [0.4, 0, 0]), (1, [0, 0.4, 0])):
        path = pkg.ColorPath(relative_colors=[np.zeros(3), np.array(rel)], base_color=np.full(3, 0.5))
        analysis.local_calibration_colors(label, baseline, None, color_path=path)
    analysis.local_calibration_values(1, [0.0, 2.0])
    return analysis, baseline


def test_heterogeneous_color_analysis_against_jax(tmp_path):
    labels = np.zeros((24, 32), np.int32)
    labels[:, 16:] = 1
    base = np.full((24, 32, 3), 0.5, np.float32)
    img = base.copy()
    img[:, 2:12, 0] += 0.2
    img[:, 20:30, 1] += 0.4
    outs = []
    for pkg in (da, dt):
        analysis, _ = _analysis(pkg, labels, base)
        image = pkg.Image(as_input(pkg, img), color_space="RGB", width=1.0, height=1.0)
        outs.append(analysis(image))
        analysis.save(tmp_path / f"{pkg.__name__}.json")
        previews = analysis.calibration_values(image, values={1: [0.0, 1.5]})
        outs.append(previews[1])
    close(outs[2], outs[0])
    close(outs[3], outs[1])
    assert json.loads((tmp_path / "darsia_tpu.json").read_text()) == json.loads(
        (tmp_path / "darsia_tpu_torch.json").read_text()
    )
    fresh = dt.HeterogeneousColorAnalysis(
        dt.Image(torch.from_numpy(base), width=1.0, height=1.0),
        dt.Image(torch.from_numpy(labels), scalar=True, width=1.0, height=1.0),
        dt.ColorMode.RELATIVE,
    )
    fresh.load(tmp_path / "darsia_tpu.json")
    close(fresh(dt.Image(torch.from_numpy(img), width=1.0, height=1.0)), outs[0])
    with pytest.raises(NotImplementedError):
        fresh.local_calibration_flash(None, None, [])


def test_labels_that_do_not_start_at_zero_raise_as_in_jax():
    """Reference-side fault: ``color_path_associations`` is sized by the
    number of labels but indexed by a label's value
    (darsia_tpu/presets/workflows/heterogeneous_color_analysis.py:73-75,
    :129); the port mirrors the IndexError."""
    labels = np.zeros((8, 8), np.int32)
    labels[:, 4:] = 3
    base = np.full((8, 8, 3), 0.5, np.float32)
    path = {pkg: pkg.ColorPath(relative_colors=[np.zeros(3), np.ones(3)], base_color=np.zeros(3)) for pkg in (da, dt)}
    for pkg in (da, dt):
        analysis = pkg.HeterogeneousColorAnalysis(
            pkg.Image(as_input(pkg, base), width=1.0, height=1.0),
            pkg.Image(as_input(pkg, labels), scalar=True, width=1.0, height=1.0),
            pkg.ColorMode.RELATIVE,
        )
        assert analysis.color_path_associations.shape == (2,)
        analysis.local_calibration_colors(0, None, None, color_path=path[pkg])
        with pytest.raises(IndexError):
            analysis.local_calibration_colors(3, None, None, color_path=path[pkg])


def test_color_analysis_defines_paths_from_pixels():
    rng = np.random.default_rng(17)
    labels = np.zeros((20, 24), np.int32)
    base = np.full((20, 24, 3), 0.4, np.float32)
    img = base + np.linspace(0, 0.3, 24, dtype=np.float32)[None, :, None] * np.array([1, 0.5, -0.5], np.float32)
    img += rng.standard_normal(img.shape).astype(np.float32) * 1e-3
    mask = np.ones((20, 24), bool)
    paths = []
    for pkg in (da, dt):
        analysis = pkg.HeterogeneousColorAnalysis(
            pkg.Image(as_input(pkg, base), width=1.0, height=1.0),
            pkg.Image(as_input(pkg, labels), scalar=True, width=1.0, height=1.0),
            pkg.ColorMode.RELATIVE,
        )
        analysis.global_calibration_colors(pkg.Image(as_input(pkg, img), width=1.0, height=1.0), mask)
        paths.append(np.asarray(analysis.color_paths[0].colors))
        assert analysis.local_calibration_color_path(
            pkg.Image(as_input(pkg, img), width=1.0, height=1.0), mask, label_box=(slice(0, 4), slice(0, 4))
        ) == 0
    np.testing.assert_allclose(paths[1], paths[0], atol=1e-6)
