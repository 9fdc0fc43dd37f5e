"""The port's config-driven analysis run against the JAX package.

The JAX package writes the workspace of
``tests/integration/test_workflow_pipeline.py`` once: a rig folder, a
colour-to-mass calibration folder, four npz photographs with a growing
plume and the protocols, under a TOML config with ``[analysis] formats =
["npz", "npy"]``.  Each package runs ``prepare_analysis_context`` and the
mass, volume and cropping steps on it into its own results folder (the port
on the CPU, its reads prefetched on worker threads).  Tolerances: CSV stems,
datetimes and columns equal; numbers within ``CSV_RTOL`` relative; exported
fields within ``tests/test_torch_color_to_mass.py``'s ``RTOL`` relative to the
field's largest value.  The CLI runs through ``main(argv, device="cpu")``.
"""

import csv
import shutil
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.workflows.analysis import (
    analysis_cropping_from_context as jax_cropping,
    analysis_mass_from_context as jax_mass,
    analysis_volume_from_context as jax_volume,
    prepare_analysis_context as jax_context,
)
from darsia_tpu_torch.presets.workflows import user_interface_analysis
from darsia_tpu_torch.presets.workflows.analysis import (
    analysis_cropping_from_context,
    analysis_mass_from_context,
    analysis_volume_from_context,
    prepare_analysis_context,
)

torch.set_num_threads(1)

START = datetime(2026, 8, 1, 12, 0, 0)
H, W = 64, 96
CSV_RTOL = 1e-5
#: tests/test_torch_color_to_mass.py's tolerance of maps in kg/m^3.
FIELD_RTOL = 1e-6


def _config_text(work: Path, results: Path, rig_folder: Path, calibration: Path) -> str:
    return f"""
[data]
folder = "{work / 'images'}"
baseline = "img_000.npz"
results = "{results}"

[rig]
width = 2.0
height = 1.0
dim = 2
path = "{rig_folder}"

[protocol]
imaging = "{work / 'imaging.csv'}"
injection = "{work / 'injection.csv'}"
pressure_temperature = "{work / 'pt.csv'}"

[roi.left]
name = "left"
corner_1 = [0.0, 0.0]
corner_2 = [1.0, 1.0]

[roi.right]
name = "right"
corner_1 = [1.0, 0.0]
corner_2 = [2.0, 1.0]

[color.path.co2]
mode = "relative"
basis = "labels"
calibration_folder = "{calibration}"

[analysis]
formats = ["npz", "npy"]

[analysis.mass]
color = "co2"
roi = ["left", "right"]
export = ["mass", "rescaled_mass"]

[analysis.volume]
roi = ["left"]

[analysis.cropping]
formats = ["npz"]
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The integration test's workspace, written by the JAX package; one
    config per package, each with its own results folder."""
    work = tmp_path_factory.mktemp("analysis_run")
    images = work / "images"
    images.mkdir()
    base = np.full((H, W, 3), 0.5, np.float32)

    def save_img(name, arr):
        da.Image(arr.astype(np.float32), width=2.0, height=1.0, color_space="RGB").save(
            images / f"{name}.npz"
        )

    da.Image(base, width=2.0, height=1.0, color_space="RGB").save(work / "baseline.npz")
    save_img("img_000", base)
    for i, growth in enumerate((8, 16, 24), start=1):
        arr = base.copy()
        arr[20 : 20 + growth, 10 : 10 + 2 * growth] += [0.3, -0.1, -0.1]
        arr[20 : 20 + growth, 58 : 58 + growth] += [0.15, -0.05, -0.05]
        save_img(f"img_{i:03d}", np.clip(arr, 0, 1))
    labels = np.zeros((H, W), np.int32)
    labels[:, 48:] = 1
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
    rig_folder = work / "rig"
    rig.save(rig_folder)
    calibration = work / "calibration" / "co2"
    paths = {
        0: da.ColorPath(relative_colors=[np.zeros(3), np.array([0.3, -0.1, -0.1])], base_color=np.full(3, 0.5)),
        1: da.ColorPath(relative_colors=[np.zeros(3), np.array([0.15, -0.05, -0.05])], base_color=np.full(3, 0.5)),
    }
    chain = da.HeterogeneousColorToMassAnalysis(
        baseline=rig.baseline,
        labels=rig.labels,
        color_mode=da.ColorMode.RELATIVE,
        color_path_interpretation={
            k: da.ColorPathInterpolation(p, da.ColorMode.RELATIVE, values=[0, 1]) for k, p in paths.items()
        },
        signal_functions={k: da.PWTransformation(supports=[0, 0.5, 1], values=[0, 0.4, 1]) for k in paths},
        flash=da.SimpleFlash(0.05, 0.5, 0.5, 1.0),
        co2_mass_analysis=da.CO2MassAnalysis(rig.baseline, atmospheric_pressure=1.01, atmospheric_temperature=22.0),
        geometry=rig.geometry,
    )
    chain.save(calibration / "color_to_mass" / "from_labels")
    configs = {}
    for name in ("jax", "port"):
        (work / f"results_{name}").mkdir()
        configs[name] = work / f"config_{name}.toml"
        configs[name].write_text(_config_text(work, work / f"results_{name}", rig_folder, calibration))
    return work, configs


@pytest.fixture(scope="module")
def runs(workspace):
    """Both packages' context and mass, volume and cropping steps; the
    port's progress events."""
    work, configs = workspace
    ctx_j = jax_context(cls=da.Rig, path=configs["jax"], all=True, require_color_to_mass=True)
    jax_out = {
        "mass": jax_mass(ctx_j),
        "volume": jax_volume(ctx_j),
        "cropping": jax_cropping(ctx_j),
    }
    ctx_t = prepare_analysis_context(
        cls=dt.Rig, path=configs["port"], all=True, require_color_to_mass=True, device="cpu"
    )
    events = []
    port_out = {
        "mass": analysis_mass_from_context(ctx_t, progress_callback=events.append),
        "volume": analysis_volume_from_context(ctx_t),
        "cropping": analysis_cropping_from_context(ctx_t),
    }
    return {"jax": (ctx_j, jax_out), "port": (ctx_t, port_out), "events": events}


def _read_csv(path: Path) -> tuple:
    with open(path, newline="") as f:
        records = list(csv.reader(f))
    return records[0], records[1:]


def _assert_csv_equal(port_csv: Path, jax_csv: Path, text_columns: tuple) -> None:
    header_t, body_t = _read_csv(port_csv)
    header_j, body_j = _read_csv(jax_csv)
    assert header_t == header_j
    assert len(body_t) == len(body_j) > 0
    for row_t, row_j in zip(body_t, body_j):
        for name, cell_t, cell_j in zip(header_j, row_t, row_j):
            if name in text_columns:
                assert cell_t == cell_j, name
            else:
                assert float(cell_t) == pytest.approx(float(cell_j), rel=CSV_RTOL, abs=1e-30), name


def test_context_matches_the_jax_package(runs):
    ctx_j, _ = runs["jax"]
    ctx_t, _ = runs["port"]
    assert [Path(p).name for p in ctx_t.image_paths] == [Path(p).name for p in ctx_j.image_paths]
    assert len(ctx_t.image_paths) == 4
    assert ctx_t.fluidflower.device.type == "cpu"
    assert ctx_t.color_to_mass_analysis is not None
    assert np.array_equal(ctx_t.analysis_labels.img.numpy(), np.asarray(ctx_j.analysis_labels.img))


def test_mass_csv_matches_the_jax_package(workspace, runs):
    work, _ = workspace
    _assert_csv_equal(
        work / "results_port" / "mass" / "mass_analysis_results.csv",
        work / "results_jax" / "mass" / "mass_analysis_results.csv",
        ("datetime", "image_stem"),
    )


def test_mass_rows_give_the_jax_frame(runs):
    _, jax_out = runs["jax"]
    _, port_out = runs["port"]
    frame = pd.DataFrame(port_out["mass"])
    assert list(frame.columns) == list(jax_out["mass"].columns)
    assert list(frame["image_stem"]) == list(jax_out["mass"]["image_stem"])
    assert list(frame["datetime"]) == list(jax_out["mass"]["datetime"])
    late = frame.sort_values("time").iloc[-1]
    assert late["detected_mass_total_rescaled"] == pytest.approx(late["exact_mass_total"], rel=1e-3)
    assert late["left_detected_mass"] <= late["detected_mass_total"] + 1e-12


def test_volume_csv_matches_the_jax_package(workspace, runs):
    work, _ = workspace
    _assert_csv_equal(
        work / "results_port" / "volume" / "volume_analysis_results.csv",
        work / "results_jax" / "volume" / "volume_analysis_results.csv",
        ("image_stem",),
    )


@pytest.mark.parametrize("mode", ["mass", "rescaled_mass"])
@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_exported_fields_match_the_jax_package(workspace, runs, mode, fmt):
    work, _ = workspace
    port_files = sorted((work / "results_port" / "mass" / mode / fmt).glob(f"*.{fmt}"))
    jax_files = sorted((work / "results_jax" / "mass" / mode / fmt).glob(f"*.{fmt}"))
    assert [p.name for p in port_files] == [p.name for p in jax_files]
    assert len(port_files) == 4
    for p, j in zip(port_files, jax_files):
        if fmt == "npz":
            got = dt.imread(p, device="cpu").img.numpy()
            want = np.asarray(da.imread(j).img)
        else:
            got, want = np.load(p), np.load(j)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= FIELD_RTOL * max(np.abs(want).max(), 1e-30)


def test_cropped_images_match_the_jax_package(workspace, runs):
    work, _ = workspace
    port_files = sorted((work / "results_port" / "cropped").glob("*.npz"))
    jax_files = sorted((work / "results_jax" / "cropped").glob("*.npz"))
    assert [p.name for p in port_files] == [p.name for p in jax_files] and len(port_files) == 4
    for p, j in zip(port_files, jax_files):
        got, want = dt.imread(p, device="cpu"), da.imread(j)
        assert np.array_equal(got.img.numpy(), np.asarray(want.img))
        assert got.date == want.date


def test_progress_events(runs):
    events = runs["events"]
    assert [e["event"] for e in events] == ["step_start"] + ["image_progress"] * 4 + ["step_complete"]
    assert [e["image_index"] for e in events[1:-1]] == [1, 2, 3, 4]


def test_mass_rerun_appends_and_sorts_as_pandas_does(workspace, runs, tmp_path):
    """A second run reads the CSV back, appends its rows and sorts by time,
    as the JAX loop does with pandas: both files stay equal."""
    work, _ = workspace
    ctx_j, _ = runs["jax"]
    ctx_t, _ = runs["port"]
    subset = slice(1, 3)
    ctx_j.image_paths = list(ctx_j.image_paths)[subset]
    ctx_t.image_paths = list(ctx_t.image_paths)[subset]
    jax_mass(ctx_j)
    rows = analysis_mass_from_context(ctx_t)
    assert len(rows) == 6
    port_csv = work / "results_port" / "mass" / "mass_analysis_results.csv"
    jax_csv = work / "results_jax" / "mass" / "mass_analysis_results.csv"
    _assert_csv_equal(port_csv, jax_csv, ("datetime", "image_stem"))
    assert list(pd.DataFrame(rows)["time"]) == sorted(pd.read_csv(jax_csv)["time"])


def test_cli_runs_on_the_cpu(workspace, runs, tmp_path):
    """``main(argv, device="cpu")`` runs the three steps; the mass CSV equals
    the one of the steps called directly."""
    work, configs = workspace
    config = tmp_path / "config.toml"
    config.write_text(configs["port"].read_text().replace(str(work / "results_port"), str(tmp_path / "results")))
    (tmp_path / "results").mkdir()
    user_interface_analysis.main(
        ["--config", str(config), "--mass", "--volume", "--cropping", "--all"], device="cpu"
    )
    mass_csv = tmp_path / "results" / "mass" / "mass_analysis_results.csv"
    header, body = _read_csv(mass_csv)
    assert len(body) == 4 and header[:3] == ["time", "datetime", "image_stem"]
    # The same port on the same CPU: the rows of the steps called directly.
    first = runs["port"][1]["mass"]
    assert header == list(first[0])
    for row, record in zip(body, first):
        assert row[2] == record["image_stem"]
        assert [float(c) for c in row[3:]] == [record[k] for k in header[3:]]
    assert len(list((tmp_path / "results" / "cropped").glob("*.npz"))) == 4
    assert (tmp_path / "results" / "volume" / "volume_analysis_results.csv").exists()
    shutil.rmtree(tmp_path / "results")


@pytest.mark.parametrize("flag", ["--segmentation", "--fingers", "--thresholding"])
def test_cli_steps_not_ported_raise(workspace, flag):
    _, configs = workspace
    with pytest.raises(NotImplementedError, match="item 6"):
        user_interface_analysis.main(["--config", str(configs["port"]), flag], device="cpu")


@pytest.mark.parametrize("ignore", [[], ["boolean_porosity"], ["image_porosity", "inner_labels"]])
def test_restoration_from_the_rig_matches_the_jax_package(runs, ignore):
    """The ignore masks of the rig's fields, and the volume averaging and
    TVD built on them, against the JAX package on the same rig folder (the
    filters within 1e-6 of values of order 1).  The TVD takes a scalar
    weight: with a weight field ("image_porosity") or a Bregman method the
    JAX package's ``build_restoration`` cannot run (ROADMAP.md Queue 3)."""
    from types import SimpleNamespace

    from darsia_tpu.presets.workflows.restoration import RestorationMaskFactory as JaxFactory
    from darsia_tpu.presets.workflows.restoration import build_restoration as jax_build
    from darsia_tpu_torch.presets.workflows.restoration import RestorationMaskFactory, build_restoration

    rig_j, rig_t = runs["jax"][0].fluidflower, runs["port"][0].fluidflower
    mask_t = RestorationMaskFactory(rig_t).build_ignore_mask(ignore)
    mask_j = JaxFactory(rig_j).build_ignore_mask(ignore)
    if not ignore:
        assert mask_t is None and mask_j is None
    else:
        assert mask_t.device.type == "cpu" and np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    data = np.random.default_rng(5).random((H, W)).astype(np.float32)
    averaging = SimpleNamespace(method="volume_average", ignore=ignore, options=SimpleNamespace(rev_size=0.1))
    tvd = SimpleNamespace(
        method="tvd",
        ignore=ignore,
        options=SimpleNamespace(
            method="chambolle", weight=0.1, max_num_iter=20, eps=1e-5, omega=1.0,
            regularization=1.0, kwargs={},
        ),
    )
    for config in (averaging, tvd):
        got = build_restoration(config, rig_t)(torch.from_numpy(data))
        want = np.asarray(jax_build(config, rig_j)(data))
        assert got.device.type == "cpu" and got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-6, config.method


def test_unknown_restoration_mask_is_refused(runs):
    from darsia_tpu_torch.presets.workflows.restoration import RestorationMaskFactory

    with pytest.raises(ValueError, match="Unknown restoration ignore mask"):
        RestorationMaskFactory(runs["port"][0].fluidflower).build_ignore_mask(["porosity"])


def test_entry_points_default_to_the_card(workspace):
    """Without ``device`` the context and the CLI run on the CUDA card: with
    no card they raise and name ``device="cpu"``."""
    from unittest import mock

    _, configs = workspace
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            prepare_analysis_context(cls=dt.Rig, path=configs["port"], all=True, require_color_to_mass=True)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            user_interface_analysis.main(["--config", str(configs["port"]), "--volume", "--all"])
