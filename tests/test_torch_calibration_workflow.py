"""The port's calibration workflows against the JAX package.

The JAX package writes one small workspace (the layout of
``tests/test_torch_analysis_workflow.py``'s: a rig folder of two labels,
npz photographs, the protocols) at 64x96: a noisy baseline and three
photographs whose plume grows and whose colour fades from its core outward,
a different colour change per label.  The TOML config adds a data registry
(the baseline photograph; the three calibration photographs), a
``[color.path.co2]`` embedding with the template's settings (2 segments,
"threshold" weighting, the expanded baseline spectrum ignored) at resolution
21, ``[calibration]`` and ``[calibration.mass]`` with ``mode = "auto"``.
Each package calibrates its own copy of the config (the port on the CPU,
through ``user_interface_calibration.main(argv, device="cpu")``): the saved
colour paths agree within ``NODE_TOL``, the chain files within
``tests/test_torch_color_to_mass.py``'s tolerances, the metadata names the
basis; ``--delete --dry-run`` lists the files and deletes none; the legacy
aliases warn and forward.  With the template's one registry key for the
embedding's ``baseline`` and ``data`` every path is the zero path in both
packages (ROADMAP.md Queue 3, reference fault 27).
"""

import json
import shutil
import warnings
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.workflows import calibration as jax_calibration
from darsia_tpu.presets.workflows import user_interface_calibration as jax_cli
from darsia_tpu_torch.presets.workflows import calibration, user_interface_calibration

torch.set_num_threads(1)

START = datetime(2026, 8, 1, 12, 0, 0)
H, W, R = 64, 96, 21
#: The saved paths' nodes are bin centres (float64 host arithmetic).
NODE_TOL = 1e-12
#: tests/test_torch_color_to_mass.py: float32 maps of values of order 1, and
#: masses relative to their size.
ATOL, RTOL = 1e-6, 1e-6
PLUME = {0: (0.3, -0.12, -0.1), 1: (-0.1, 0.25, 0.15)}


def _photo(base: np.ndarray, labels: np.ndarray, radius: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:H, 0:W]
    img = base.astype(np.float64).copy()
    for label, (r0, c0) in ((0, (32, 24)), (1, (32, 72))):
        dist = np.hypot(rows - r0, cols - c0) / radius
        strength = np.clip(1.0 - dist, 0.0, 1.0)[..., None]
        colour = strength * np.asarray(PLUME[label]) * (labels == label)[..., None]
        img += colour + 0.004 * rng.standard_normal((H, W, 3)) * (strength > 0)
    return np.clip(img, 0, 1).astype(np.float32)


def config_text(work: Path, results: Path, extra: str = "") -> str:
    images = work / "images"
    calib = ", ".join(f'"{images / f"img_{i:03d}.npz"}"' for i in (1, 2, 3))
    return f"""
[data]
folder = "{images}"
baseline = "img_000.npz"
results = "{results}"

[data.path.baseline_imgs]
paths = ["{images / 'img_000.npz'}"]

[data.path.calibration_imgs]
paths = [{calib}]

[rig]
width = 2.0
height = 1.0
dim = 2
path = "{work / 'rig'}"

[protocol]
imaging = "{work / 'imaging.csv'}"
injection = "{work / 'injection.csv'}"
pressure_temperature = "{work / 'pt.csv'}"

[roi.left]
name = "left"
corner_1 = [0.0, 0.0]
corner_2 = [1.0, 1.0]

[color.path.co2]
mode = "relative"
basis = "labels"
num_segments = 2
resolution = {R}
histogram_weighting = "threshold"
baseline = "baseline_imgs"
data = "calibration_imgs"

[calibration]
data = "calibration_imgs"

[calibration.color]
color = "co2"

[calibration.mass]
color = "co2"
mode = "auto"
threshold = 0.3
maxiter = 6

[analysis.mass]
color = "co2"
{extra}"""


def write_workspace(work: Path) -> dict:
    """The photographs, rig, protocols and one config per package (each
    with its own results folder); returns the config paths."""
    images = work / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = np.clip(0.5 + 0.02 * rng.standard_normal((H, W, 3)), 0, 1).astype(np.float32)
    labels = np.zeros((H, W), np.int32)
    labels[:, 48:] = 1

    def save(name, arr):
        da.Image(arr, width=2.0, height=1.0, color_space="RGB").save(images / f"{name}.npz")

    da.Image(base, width=2.0, height=1.0, color_space="RGB").save(work / "baseline.npz")
    save("img_000", base)
    for i, radius in enumerate((10.0, 16.0, 22.0), start=1):
        save(f"img_{i:03d}", _photo(base, labels, radius, seed=i))
    np.save(work / "labels.npy", labels)
    np.save(work / "depth.npy", np.full((H, W), 0.02, np.float32))
    (work / "facies.csv").write_text("id,porosity,permeability\n0,0.44,2e-10\n1,0.36,9e-11\n")
    rows = ["image_id,datetime,path"]
    for i in range(4):
        rows.append(f"{i},{(START + timedelta(hours=i)).isoformat()},img_{i:03d}.npz")
    (work / "imaging.csv").write_text("\n".join(rows))
    (work / "injection.csv").write_text(
        "location_x,location_y,start,end,rate_kg_s\n"
        f"0.5,0.5,{START.isoformat()},{(START + timedelta(hours=3)).isoformat()},{0.002 / 3600 / 3}\n"
    )
    (work / "pt.csv").write_text(
        "datetime,pressure,temperature\n"
        f"{START.isoformat()},1.01,22.0\n{(START + timedelta(hours=4)).isoformat()},1.01,22.0\n"
    )

    class Exp0:
        experiment_start = START
        injection_protocol = None
        pressure_temperature_protocol = None

        def get_datetime(self, path):
            return START

    rig = da.Rig()
    rig.setup(
        experiment=Exp0(),
        baseline_path=work / "baseline.npz",
        depth_map_path=work / "depth.npy",
        labels_path=work / "labels.npy",
        facies_props_path=work / "facies.csv",
    )
    rig.save(work / "rig")
    configs = {}
    for name in ("jax", "port"):
        (work / f"results_{name}").mkdir()
        configs[name] = work / f"config_{name}.toml"
        configs[name].write_text(config_text(work, work / f"results_{name}"))
    return configs


def _folder(config_path: Path, kind: str) -> Path:
    results = Path(config_path).parent / f"results_{Path(config_path).stem.split('_')[1]}"
    return results / "calibration" / "color" / "co2" / kind / "from_labels"


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """Both packages' colour and colour-to-mass calibrations (the port's
    through its CLI), and the port's chain."""
    work = tmp_path_factory.mktemp("calibration_run")
    configs = write_workspace(work)
    jax_calibration.calibration_color_paths(configs["jax"], cls=da.Rig)
    jax_chain = jax_calibration.calibration_color_to_mass_analysis(configs["jax"], cls=da.Rig)
    user_interface_calibration.main(["--config", str(configs["port"]), "--color", "--mass"], device="cpu")
    return work, configs, jax_chain


def test_color_paths_against_jax(calibrated):
    _, configs, _ = calibrated
    jax_paths = dt.LabelColorPathMap.load(_folder(configs["jax"], "color_paths"))
    port_paths = dt.LabelColorPathMap.load(_folder(configs["port"], "color_paths"))
    assert sorted(port_paths) == sorted(jax_paths) == [0, 1]
    for label in jax_paths:
        got, want = np.asarray(port_paths[label].relative_colors), np.asarray(jax_paths[label].relative_colors)
        assert got.shape == want.shape == (3, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=NODE_TOL)
        np.testing.assert_array_equal(port_paths[label].base_color, jax_paths[label].base_color)
        # Away from the base colour, towards the label's plume colour.
        assert np.dot(got[-1], PLUME[label]) > 0.5 * np.dot(PLUME[label], PLUME[label])


def test_metadata_names_the_basis(calibrated):
    _, configs, _ = calibrated
    for kind in ("color_paths", "color_to_mass"):
        port = calibration.read_calibration_metadata(_folder(configs["port"], kind))
        jax = json.loads((_folder(configs["jax"], kind) / "calibration_metadata.json").read_text())
        assert port["basis"] == jax["basis"] == "labels"
        assert port["embedding_id"] == jax["embedding_id"] == "co2"
    calibration.validate_basis_metadata(_folder(configs["port"], "color_paths"), "labels")
    with pytest.raises(ValueError, match="basis"):
        calibration.validate_basis_metadata(_folder(configs["port"], "color_paths"), "facies")


def test_chain_files_against_jax(calibrated):
    _, configs, _ = calibrated
    port, jax = _folder(configs["port"], "color_to_mass"), _folder(configs["jax"], "color_to_mass")
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jax.iterdir())
    port_flash, jax_flash = np.load(port / "flash.npz"), np.load(jax / "flash.npz")
    assert sorted(port_flash.files) == sorted(jax_flash.files)
    for key in jax_flash.files:
        if jax_flash[key].dtype.kind in "fi":
            np.testing.assert_allclose(port_flash[key], jax_flash[key], rtol=RTOL, atol=ATOL)
        else:
            assert port_flash[key] == jax_flash[key], key
    for label in (0, 1):
        got = np.loadtxt(port / f"signal_function_{label}.csv", delimiter=",", skiprows=1)
        want = np.loadtxt(jax / f"signal_function_{label}.csv", delimiter=",", skiprows=1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        got = json.loads((port / f"color_interpretation_{label}.json").read_text())
        want = json.loads((jax / f"color_interpretation_{label}.json").read_text())
        assert got.keys() == want.keys()
        for key in want:
            if isinstance(want[key], (list, float, int)):
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=NODE_TOL)
            else:
                assert got[key] == want[key], key


def test_calibrated_chain_gives_the_jax_mass(calibrated):
    work, configs, jax_chain = calibrated
    ctx = dt.presets.workflows.analysis.prepare_analysis_context(
        cls=dt.Rig, path=configs["port"], section="calibration", device="cpu"
    )
    rig = ctx.fluidflower
    chain = dt.HeterogeneousColorToMassAnalysis.from_folder(
        _folder(configs["port"], "color_to_mass"),
        baseline=rig.baseline,
        labels=rig.labels,
        co2_mass_analysis=dt.CO2MassAnalysis(rig.baseline, 1.01, 22.0),
        geometry=rig.geometry,
    )
    jax_rig = da.Rig.load(work / "rig")
    for path in ctx.image_paths:
        mass = rig.geometry.integrate(chain(rig.read_image(path)).mass)
        jax_img = da.imread(path, transformations=jax_rig.corrections)
        want = jax_rig.geometry.integrate(jax_chain(jax_img).mass)
        assert mass == pytest.approx(float(want), rel=RTOL, abs=1e-12)


def test_delete_dry_run_lists_and_keeps(calibrated, capsys):
    _, configs, _ = calibrated
    user_interface_calibration.main(["--config", str(configs["port"]), "--delete", "--dry-run"], device="cpu")
    listed = capsys.readouterr().out.split()
    want = [str(p) for p in jax_calibration.collect_existing_calibration_paths_to_delete(configs["port"])]
    assert listed == want and len(listed) >= 2 + 6 + 1
    assert all(Path(p).exists() for p in listed)


def test_delete_removes_every_file(calibrated, tmp_path):
    work, configs, _ = calibrated
    copy = tmp_path / "results_port"
    shutil.copytree(work / "results_port", copy)
    config = tmp_path / "config_port.toml"
    config.write_text(configs["port"].read_text().replace(str(work / "results_port"), str(copy)))
    files = calibration.delete_calibration(config)
    assert files and not any(p.exists() for p in files)
    assert calibration.collect_existing_calibration_paths_to_delete(config) == []


def test_parser_matches_the_jax_cli():
    port, jax = user_interface_calibration.build_parser_for_calibration(), jax_cli.build_parser_for_calibration()
    summary = lambda p: sorted((a.dest, a.default, a.nargs, a.required) for a in p._actions)  # noqa: E731
    assert summary(port) == summary(jax)


@pytest.mark.parametrize(
    "alias, step",
    [
        ("calibration_color_analysis", "calibration_color_paths"),
        ("calibration_color_signal", "calibration_color_to_mass_analysis"),
        ("calibration_flash", "calibration_color_to_mass_analysis"),
        ("calibration_mass_analysis", "calibration_color_to_mass_analysis"),
    ],
)
def test_legacy_aliases_warn_and_forward(monkeypatch, alias, step):
    from darsia_tpu_torch.presets.workflows.calibration import legacy

    calls = []
    monkeypatch.setattr(legacy, step, lambda path, **kw: calls.append((path, kw)) or "done")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert getattr(legacy, alias)("config.toml", device="cpu") == "done"
        assert getattr(legacy, alias)(dt.Rig, "config.toml") == "done"
    assert [w.category for w in caught] == [DeprecationWarning] * 2
    assert alias in str(caught[0].message) and "[calibration.color]" in str(caught[0].message)
    assert [c[0] for c in calls] == ["config.toml"] * 2
    assert calls[0][1]["cls"] is None and calls[0][1]["device"] == "cpu" and calls[1][1]["cls"] is dt.Rig


def test_one_key_for_baseline_and_data_gives_zero_paths(calibrated, tmp_path):
    """Reference fault 27: the calibration photographs' own spectrum is
    ignored, so nothing is left to fit."""
    work, configs, _ = calibrated
    paths = {}
    for name, package, cls in (("jax", jax_calibration, da.Rig), ("port", calibration, dt.Rig)):
        results = tmp_path / f"results_{name}"
        results.mkdir()
        config = tmp_path / f"config_{name}.toml"
        config.write_text(
            config_text(work, results).replace('baseline = "baseline_imgs"', 'baseline = "calibration_imgs"')
        )
        kwargs = {"device": "cpu"} if name == "port" else {}
        package.calibration_color_paths(config, cls=cls, **kwargs)
        paths[name] = dt.LabelColorPathMap.load(_folder(config, "color_paths"))
    for label in (0, 1):
        for name in paths:
            np.testing.assert_array_equal(np.asarray(paths[name][label].relative_colors), np.zeros((3, 3)))
