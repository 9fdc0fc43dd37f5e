"""The port's multiphase calibration session and legacy meta file against
the JAX package.

``TransformationCalibrationSession`` on the synthetic series of
``tests/unit/test_experiment_multiphase.py`` (signal fields whose detected
mass scales with the gas transformation's end value), the port's maps as
CPU tensors: every proposal's metrics within 1e-6 relative of JAX's, the
same log file, and ``auto`` (scipy's Nelder-Mead in both) to the same
values within 1e-6.  ``preview`` with a path draws where matplotlib imports
and raises naming it where it does not.  ``FluidFlowerCO2Meta`` reads the
same TOML and JSON meta files to equal paths.
"""

import json
import sys

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 8, 10
TIMES = [0.5, 1.0, 1.5, 2.0]


def _session(pkg, tmp_path, true_scale: float = 2.0, log: str = "log"):
    geometry = pkg.Geometry(space_dim=2, num_voxels=(H, W), dimensions=[1, 1])
    analysis = pkg.MultiphaseTimeSeriesAnalysis(geometry)
    tf_g = pkg.PWTransformation(supports=[0.0, 1.0], values=[0.0, 1.0])
    tf_aq = pkg.PWTransformation(supports=[0.0, 1.0], values=[0.0, 1.0])
    paths = [tmp_path / f"img_{i}.npz" for i in range(len(TIMES))]
    signals = {}
    for k, (p, t) in enumerate(zip(paths, TIMES)):
        signal = np.full((H, W), 0.5, np.float32)
        signal[k : k + 3, 2:7] = 0.8
        signals[p] = (signal if pkg is da else torch.from_numpy(signal), t)
        p.write_bytes(b"")

    def mass_analysis_from_pre(pre):
        signal, t = pre
        mass_map = pkg.ScalarImage(tf_g(signal) * t, width=1.0, height=1.0)
        zeros = np.zeros((H, W), np.float32)
        zero = pkg.ScalarImage(zeros if pkg is da else torch.from_numpy(zeros), width=1, height=1)
        return pkg.MassAnalysisResults(time=t, mass=mass_map, mass_g=mass_map, mass_aq=zero)

    return pkg.TransformationCalibrationSession(
        tf_g,
        tf_aq,
        paths,
        analysis,
        upper_time_limit=1.25,
        read_image=lambda path: path,
        pre_mass_analysis=lambda path: signals[path],
        mass_analysis_from_pre=mass_analysis_from_pre,
        expected_mass=lambda t: true_scale * 0.5 * t,
        log=tmp_path / f"{log}_{pkg.__name__}",
    )


def _close(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("values_g", [None, [0.0, 2.0], [0.1, 1.4]])
def test_propose_accept_equal(tmp_path, values_g):
    port, ref = _session(dt, tmp_path), _session(da, tmp_path)
    _close(port.propose(), ref.propose())
    _close(port.propose(values_g=values_g, values_aq=[0.0, 0.5]), ref.propose(values_g=values_g, values_aq=[0.0, 0.5]))
    tf_g, tf_aq = port.accept()
    ref.accept()
    assert port.accepted and tf_g is port.transformation_g
    got = np.load(tmp_path / "log_darsia_tpu_torch" / "calibration_log.npz")
    want = np.load(tmp_path / "log_darsia_tpu" / "calibration_log.npz")
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)


def test_preview(tmp_path, monkeypatch):
    port, ref = _session(dt, tmp_path), _session(da, tmp_path)
    port.propose(values_g=[0.0, 2.0])
    ref.propose(values_g=[0.0, 2.0])
    _close(port.preview(), ref.preview())
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            port.preview(path=tmp_path / "preview.png")
    else:
        _close(port.preview(path=tmp_path / "preview.png"), ref.preview())
        assert (tmp_path / "preview.png").exists()
    # matplotlib as on a machine without it.
    for name in [n for n in sys.modules if n.split(".")[0] == "matplotlib"] + ["matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="matplotlib"):
        port.preview(path=tmp_path / "blocked.png")
    assert not (tmp_path / "blocked.png").exists()


@pytest.mark.parametrize("calibrate", ["g", "both"])
def test_auto_equal(tmp_path, calibrate):
    port, ref = _session(dt, tmp_path, true_scale=3.0), _session(da, tmp_path, true_scale=3.0)
    got = port.auto(maxiter=60, calibrate=calibrate)
    want = ref.auto(maxiter=60, calibrate=calibrate)
    assert got["optimizer_iterations"] == want["optimizer_iterations"]
    np.testing.assert_allclose(port.transformation_g.values, ref.transformation_g.values, rtol=1e-6)
    np.testing.assert_allclose(port.transformation_aq.values, ref.transformation_aq.values, rtol=1e-6)
    assert got["error"] == pytest.approx(want["error"], rel=1e-6, abs=1e-12)


def test_calibrate_transformations_equal(tmp_path):
    sessions = {}
    for pkg in (dt, da):
        s = _session(pkg, tmp_path, true_scale=2.5)
        pkg.calibrate_transformations(
            s.transformation_g,
            s.transformation_aq,
            s.paths,
            s.analysis,
            s.upper_time_limit,
            lambda path: path,
            lambda path, s=s: s.pre_mass_results[path],
            s.mass_analysis_from_pre,
            log=tmp_path / f"fn_{pkg.__name__}",
            expected_mass=s.expected_mass,
            maxiter=40,
        )
        sessions[pkg] = s
    np.testing.assert_allclose(
        sessions[dt].transformation_g.values, sessions[da].transformation_g.values, rtol=1e-6
    )
    assert (tmp_path / "fn_darsia_tpu_torch" / "calibration_log.npz").exists()


@pytest.mark.parametrize("suffix", [".toml", ".json"])
def test_fluidflower_co2_meta_equal(tmp_path, suffix):
    data = tmp_path / "data"
    data.mkdir()
    for k in range(3):
        (data / f"img_{k}.JPG").write_bytes(b"")
    meta = {
        "data": {"folder": str(data), "baseline": "img_0.JPG", "pad": 5},
        "input": {"folder": str(tmp_path / "input"), "segmentation": "labels.npy"},
        "common": {"folder": str(tmp_path / "common"), "labels": "labels.npy"},
        "results": {"folder": str(tmp_path / "results"), "fluidflower": "ff"},
    }
    path = tmp_path / f"meta{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(meta))
    else:
        lines = []
        for section, values in meta.items():
            lines.append(f"[{section}]")
            lines += [f'{k} = {json.dumps(v)}' for k, v in values.items()]
        path.write_text("\n".join(lines) + "\n")
    port, ref = dt.FluidFlowerCO2Meta(path), da.FluidFlowerCO2Meta(path)
    for name in (
        "data", "baseline", "pad", "input_folder", "segmentation", "common_folder", "labels",
        "depth_measurements", "results", "fluidflower_folder", "co2_analysis_data",
        "co2_g_analysis_data", "pw_transformation_g_data", "pw_transformation_aq_data", "log_folder",
    ):
        assert getattr(port, name) == getattr(ref, name), name
    for pkg_meta in (port, ref):
        pkg_meta.update("labels", tmp_path / "other.npy")
    assert port.labels == ref.labels
    with pytest.raises(ValueError):
        port.update("unknown", tmp_path)
