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

The config also holds ``[analysis.segmentation]``, ``[analysis.fingers]``
(two entries: the gas saturation over both ROIs with the skeleton
analysis, the dissolved concentration over the frame with the skeleton
and the gradient-based interface) and ``[analysis.thresholding]``.  The
finger step's CSVs and ``statistics.json`` equal the JAX step's (text cells
equal, numbers within ``STEP_RTOL`` relative), a rerun appends as pandas
does, the interface ``.npy`` files agree; the segmentation and thresholding
masks are equal (compared here, where matplotlib imports, as the steps
compute them) and both steps raise, naming matplotlib, before they read a
photograph when its import is blocked.
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
#: Lengths, coordinates and speeds of the finger step (float64 host
#: arithmetic on equal contour points; coordinates through each package's
#: coordinate system).
STEP_RTOL = 1e-6


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

[analysis.segmentation]
label = "CO2"
mode = "saturation_g"
thresholds = [0.5, 0.2]
color = [[255, 255, 0], [0, 255, 255]]

[analysis.fingers.plume]
mode = "saturation_g"
threshold = 0.5
roi = ["left", "right"]
include_skeleton_analysis = true

[analysis.fingers.interface]
mode = "concentration_aq"
threshold = 0.05
include_skeleton_analysis = true
include_gradient_based_analysis = true
gradient_mode = "saturation_g"

[analysis.thresholding.layer.gas]
mode = "saturation_g"
threshold_min = 0.5

[analysis.thresholding.layer.dissolved]
mode = "concentration_aq"
threshold_min = 0.05
threshold_max = 0.9
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The integration test's workspace, written by the JAX package; one
    config per package, each with its own results folder."""
    return write_workspace(tmp_path_factory.mktemp("analysis_run"))


def write_workspace(work: Path, names=("jax", "port")) -> tuple:
    """Write the workspace into ``work``: photographs, protocols, the rig
    and the calibration folder (by the JAX package), and one config per
    name, each with its own results folder."""
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
    for name in names:
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
            if name in text_columns or cell_j == "":
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


# ------------------------------------------------- segmentation, fingers, thresholding


@pytest.fixture(scope="module")
def step_runs(workspace, tmp_path_factory):
    """Both packages' contexts of their own, each with its own results
    folder; the finger step run once by each."""
    from darsia_tpu.presets.workflows.analysis import analysis_fingers_from_context as jax_fingers
    from darsia_tpu_torch.presets.workflows.analysis import analysis_fingers_from_context

    work, configs = workspace
    out = {}
    for name in ("jax", "port"):
        config = work / f"steps_{name}.toml"
        results = tmp_path_factory.mktemp(f"steps_{name}")
        config.write_text(configs[name].read_text().replace(str(work / f"results_{name}"), str(results)))
        out[name] = {"config": config, "results": results}
    out["jax"]["ctx"] = jax_context(cls=da.Rig, path=out["jax"]["config"], all=True, require_color_to_mass=True)
    out["port"]["ctx"] = prepare_analysis_context(
        cls=dt.Rig, path=out["port"]["config"], all=True, require_color_to_mass=True, device="cpu"
    )
    out["jax"]["rows"] = jax_fingers(out["jax"]["ctx"])
    out["port"]["rows"] = analysis_fingers_from_context(out["port"]["ctx"])
    return out


def _assert_json_close(got, want, where: str = "") -> None:
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for key in want:
            _assert_json_close(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for k, (a, b) in enumerate(zip(got, want)):
            _assert_json_close(a, b, f"{where}[{k}]")
    elif isinstance(want, float):
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            assert got == pytest.approx(want, rel=STEP_RTOL, abs=1e-12), where
    else:
        assert got == want, where


FINGER_TEXT = ("image_stem", "entry", "roi", "key", "image")


def test_fingers_step_matches_the_jax_package(step_runs):
    import json

    port, ref = step_runs["port"]["results"] / "fingers", step_runs["jax"]["results"] / "fingers"
    for name in ("fingers_analysis_results.csv", "statistics.csv"):
        _assert_csv_equal(port / name, ref / name, FINGER_TEXT)
    stats = pd.read_csv(port / "statistics.csv")
    # 4 photographs x (2 ROIs of the plume entry + the interface entry's frame).
    assert len(stats) == 12 and (stats["number_tips"] >= 0).all()
    assert (stats["number_new_fingers"] + stats["number_continuing_fingers"] == stats["number_fingers"]).all()
    _assert_json_close(
        json.loads((port / "statistics.json").read_text()), json.loads((ref / "statistics.json").read_text())
    )
    rates = sorted(p.relative_to(ref) for p in ref.glob("paths/*/*_advance_rates.csv"))
    assert rates and rates == sorted(p.relative_to(port) for p in port.glob("paths/*/*_advance_rates.csv"))
    for rel in rates:
        _assert_csv_equal(port / rel, ref / rel, ())
    arcs = sorted(p.relative_to(ref) for p in ref.glob("interface-contour-npy/*/*.npy"))
    assert len(arcs) == 4
    assert arcs == sorted(p.relative_to(port) for p in port.glob("interface-contour-npy/*/*.npy"))
    for rel in arcs:
        got, want = np.load(port / rel, allow_pickle=True), np.load(ref / rel, allow_pickle=True)
        assert got.shape == want.shape
        for a, b in zip(got.reshape(-1), want.reshape(-1)):
            assert np.abs(np.asarray(a, float) - np.asarray(b, float)).max() <= 1e-6


def test_fingers_rows_give_the_jax_frame(step_runs):
    rows = step_runs["port"]["rows"]
    frame = pd.DataFrame(rows)
    want = step_runs["jax"]["rows"]
    assert list(frame.columns) == list(want.columns)
    assert list(frame["image_stem"]) == list(want["image_stem"])
    np.testing.assert_allclose(frame["contour_length"], want["contour_length"], rtol=STEP_RTOL)


def test_fingers_rerun_appends_as_pandas_does(step_runs):
    from darsia_tpu.presets.workflows.analysis import analysis_fingers_from_context as jax_fingers
    from darsia_tpu_torch.presets.workflows.analysis import analysis_fingers_from_context

    ctx_j, ctx_t = step_runs["jax"]["ctx"], step_runs["port"]["ctx"]
    paths_j, paths_t = list(ctx_j.image_paths), list(ctx_t.image_paths)
    ctx_j.image_paths, ctx_t.image_paths = paths_j[2:], paths_t[2:]
    try:
        jax_fingers(ctx_j)
        rows = analysis_fingers_from_context(ctx_t)
    finally:
        ctx_j.image_paths, ctx_t.image_paths = paths_j, paths_t
    assert len(rows) == 4 * 3 + 2 * 3
    port, ref = step_runs["port"]["results"] / "fingers", step_runs["jax"]["results"] / "fingers"
    for name in ("fingers_analysis_results.csv", "statistics.csv"):
        _assert_csv_equal(port / name, ref / name, FINGER_TEXT)


def _mode_fields(pkg_ctx, img, mode: str):
    """The mode image of a photograph, as the steps resolve it."""
    result = pkg_ctx.color_to_mass_analysis(img)
    return getattr(result, mode).img


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_segmentation_and_thresholding_masks_equal(step_runs, index):
    from darsia_tpu.presets.workflows.segmentation_contours import SegmentationContours as JaxContours
    from darsia_tpu_torch.presets.workflows.analysis.analysis_thresholding import layer_mask
    from darsia_tpu_torch.presets.workflows.segmentation_contours import (
        GradientBasedSegmentation,
        SegmentationContours,
    )
    from darsia_tpu.presets.workflows.segmentation_contours import GradientBasedSegmentation as JaxGradient

    ctx_j, ctx_t = step_runs["jax"]["ctx"], step_runs["port"]["ctx"]
    path_j, path_t = list(ctx_j.image_paths)[index], list(ctx_t.image_paths)[index]
    img_j, img_t = ctx_j.fluidflower.read_image(path_j), ctx_t.fluidflower.read_image(path_t)
    res_j, res_t = ctx_j.color_to_mass_analysis(img_j), ctx_t.color_to_mass_analysis(img_t)
    entry = ctx_t.config.analysis.segmentation.config
    entry_j = ctx_j.config.analysis.segmentation.config
    for threshold in entry.thresholds:
        got = SegmentationContours(entry).extract_mask(img_t, threshold, mass_analysis_result=res_t)
        want = JaxContours(entry_j).extract_mask(img_j, threshold, mass_analysis_result=res_j)
        field = np.asarray(res_j.saturation_g.img)
        near = np.abs(field - threshold) <= 1e-6
        assert got.device.type == "cpu" and got.dtype == torch.bool
        assert not ((got.numpy() != want) & ~near).any()
    field = np.asarray(res_j.saturation_g.img, dtype=float)
    modulus = np.sqrt(sum(np.gradient(field, axis=axis) ** 2 for axis in range(2)))
    for threshold in (0.01, 0.05):
        got = GradientBasedSegmentation("saturation_g", threshold).extract_mask(img_t, mass_analysis_result=res_t)
        want = JaxGradient("saturation_g", threshold).extract_mask(img_j, mass_analysis_result=res_j)
        near = np.abs(modulus - threshold) <= 1e-6
        assert not ((got.numpy() != want) & ~near).any()
    for key, layer in ctx_t.config.analysis.thresholding.layers.items():
        field_t = getattr(res_t, layer.mode).img
        field_j = np.asarray(getattr(res_j, layer.mode).img)
        got = layer_mask(layer, field_t).numpy()
        want = np.ones(field_j.shape, bool)
        near = np.zeros(field_j.shape, bool)
        for bound, op in ((layer.threshold_min, np.greater_equal), (layer.threshold_max, np.less_equal)):
            if bound is not None:
                want &= op(field_j, bound)
                near |= np.abs(field_j - bound) <= 1e-6
        assert not ((got != want) & ~near).any(), key


@pytest.mark.parametrize("step", ["segmentation", "thresholding"])
def test_drawing_steps_run_where_matplotlib_imports(step_runs, step):
    pytest.importorskip("matplotlib")
    from darsia_tpu_torch.presets.workflows import analysis

    ctx = step_runs["port"]["ctx"]
    getattr(analysis, f"analysis_{step}_from_context")(ctx)
    folder = step_runs["port"]["results"] / step
    figures = sorted(folder.rglob("*.jpg"))
    assert len(figures) == 4


def _block_matplotlib(monkeypatch):
    """matplotlib as on a machine without it: a ``None`` entry in
    ``sys.modules`` makes every import of it raise."""
    import sys

    for name in [n for n in sys.modules if n.split(".")[0] == "matplotlib"] + ["matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("step", ["segmentation", "thresholding"])
def test_drawing_steps_name_matplotlib_before_reading(step_runs, step, monkeypatch):
    from darsia_tpu_torch.presets.workflows import analysis

    ctx = step_runs["port"]["ctx"]
    reads = []
    monkeypatch.setattr(ctx.fluidflower, "read_image", lambda path: reads.append(path))
    _block_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="matplotlib"):
        getattr(analysis, f"analysis_{step}_from_context")(ctx)
    with pytest.raises(ImportError, match="matplotlib"):
        user_interface_analysis.main(["--config", str(step_runs["port"]["config"]), f"--{step}"], device="cpu")
    assert reads == []


@pytest.mark.parametrize("matplotlib", ["importing", "blocked"])
def test_cli_fingers_runs_on_the_cpu(step_runs, tmp_path, monkeypatch, matplotlib):
    """``main([..., "--fingers", "--all"], device="cpu")``: one row per
    photograph and ROI in ``statistics.csv``; without matplotlib no overlay
    is drawn and every table and the JSON are still written."""
    if matplotlib == "blocked":
        _block_matplotlib(monkeypatch)
    config = tmp_path / "config.toml"
    config.write_text(
        step_runs["port"]["config"].read_text().replace(str(step_runs["port"]["results"]), str(tmp_path / "results"))
    )
    (tmp_path / "results").mkdir()
    user_interface_analysis.main(["--config", str(config), "--fingers", "--all"], device="cpu")
    folder = tmp_path / "results" / "fingers"
    stats = pd.read_csv(folder / "statistics.csv")
    assert len(stats) == 12
    assert sorted(set(stats["key"])) == ["full", "left", "right"]
    assert (folder / "statistics.json").exists() and (folder / "fingers_analysis_results.csv").exists()
    assert len(list(folder.glob("interface-contour-npy/*/*.npy"))) == 4
    drawn = list(folder.rglob("*.png"))
    assert (len(drawn) > 0) == (matplotlib == "importing")
