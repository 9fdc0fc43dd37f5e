"""The port's helper and utility workflows against the JAX package.

On the workspace of ``tests/test_torch_calibration_workflow.py`` (64x96, a
rig of two labels, npz photographs, the protocols) with ``[helper.results]``,
``[utils]`` and ``[download]`` sections and mass fields the JAX package
wrote: the colour report within ``REPORT_TOL``, the loaded result frames and
their statistics equal, the re-exported fields equal, the ROI snippet equal,
the active-region mask, rendering and contours equal, the calibration bundle
copied byte for byte out and into a second results folder, the download plan
equal; the helper and utils CLIs with ``device="cpu"``, the cached image
loader (its second pass reads no photograph), and the parts that need OpenCV
or the interactive assistants raising and naming them.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_calibration_workflow import config_text, write_workspace

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.workflows import basis as jax_basis
from darsia_tpu.presets.workflows import helper as jax_helper
from darsia_tpu.presets.workflows import user_interface_helper as jax_helper_cli
from darsia_tpu.presets.workflows import user_interface_utils as jax_utils_cli
from darsia_tpu.presets.workflows import utils as jax_utils
from darsia_tpu.presets.workflows.utils import roi_visualization as jax_roi
from darsia_tpu_torch.presets.workflows import (
    helper,
    label_ids_from_image,
    user_interface_helper,
    user_interface_utils,
    utils,
)
from darsia_tpu_torch.presets.workflows.utils import roi_visualization

torch.set_num_threads(1)

# (The package's __init__ exports a function of the module's name.)
jax_helper_roi = importlib.import_module("darsia_tpu.presets.workflows.helper.helper_roi")

#: The JAX report converts in float32 and reduces in numpy's float32; the
#: port converts in float32 and reduces with torch (LAB values are of order
#: 100, so this is a relative 1e-7).
REPORT_TOL = 1e-5


def _extra(work: Path, results: Path, fmt: str) -> str:
    return f"""
[helper.results]
mode = "mass"
format = "{fmt}"

[utils]
export_calibration_bundle = "{work / f'bundle_{results.name}'}"
import_calibration_bundle = "{work / 'bundle_results_port'}"

[download]
source = "{work / 'images'}"
folder = "{work / f'download_{results.name}'}"
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The workspace, mass fields and a calibration tree (both written by the
    JAX package), and per package a config per re-export format."""
    work = tmp_path_factory.mktemp("helpers")
    write_workspace(work)
    rng = np.random.default_rng(5)
    fields = [rng.random((64, 96)).astype(np.float32) * i for i in range(3)]
    tree = {f"{sub}/file_{k}.bin": rng.bytes(100 + k) for sub in ("color_paths", "color_to_mass") for k in range(2)}
    configs = {}
    for name in ("jax", "port", "import"):
        results = work / f"results_{name}"
        results.mkdir(exist_ok=True)
        for fmt in ("npz", "csv"):
            configs[name, fmt] = work / f"config_{name}_{fmt}.toml"
            configs[name, fmt].write_text(config_text(work, results, _extra(work, results, fmt)))
        if name == "import":
            continue
        folder = results / "mass" / "mass" / "npz"
        folder.mkdir(parents=True)
        for i, field in enumerate(fields):
            da.ScalarImage(field, width=2.0, height=1.0).save(folder / f"img_{i:03d}.npz")
        for relative, content in tree.items():
            file = results / "calibration" / "color" / "co2" / relative
            file.parent.mkdir(parents=True, exist_ok=True)
            file.write_bytes(content)
    return work, configs


def test_label_ids_from_image():
    labels = np.array([[-1, 3, 0], [2, 3, -5]])
    assert label_ids_from_image(torch.from_numpy(labels)) == jax_basis.label_ids_from_image(labels) == [0, 2, 3]
    assert label_ids_from_image(labels) == [0, 2, 3]


@pytest.mark.parametrize("scale", [1.0, 255.0])
@pytest.mark.parametrize("box", [None, (slice(5, 40), slice(10, 70))])
def test_color_report_against_jax(scale, box):
    rng = np.random.default_rng(3)
    data = (rng.random((48, 80, 3)) * scale).astype(np.float32)
    port = helper.color_report(dt.Image(torch.from_numpy(data), width=1.0, height=0.6), box)
    jax = jax_helper.color_report(da.Image(data, width=1.0, height=0.6), box)
    assert port.keys() == jax.keys() == {"RGB", "HSV", "LAB"}
    for space in jax:
        assert port[space].keys() == jax[space].keys()
        for stat in jax[space]:
            np.testing.assert_allclose(port[space][stat], jax[space][stat], rtol=REPORT_TOL, atol=REPORT_TOL)


def test_load_result_frames_against_jax(workspace):
    work, _ = workspace
    files = sorted((work / "results_jax" / "mass" / "mass" / "npz").glob("*.npz"))
    port = helper.load_result_frames(files, device="cpu")
    jax = jax_helper.load_result_frames(files)
    assert len(port) == len(jax) == 3
    for p, j in zip(port, jax):
        assert (p.source_name, p.result_path) == (j.source_name, j.result_path)
        assert (p.minimum, p.maximum, p.integral) == (j.minimum, j.maximum, j.integral)
        np.testing.assert_array_equal(p.image.img.numpy(), np.asarray(j.image.img))


@pytest.mark.parametrize("fmt", ["npz", "csv"])
def test_helper_cli_results_against_jax(workspace, fmt):
    work, configs = workspace
    user_interface_helper.main(["--config", str(configs["port", fmt]), "--results"], device="cpu")
    jax_helper.helper_results(configs["jax", fmt], cls=da.Rig)
    port_files = sorted((work / "results_port" / "helper" / "mass").glob(f"*.{fmt}"))
    jax_files = sorted((work / "results_jax" / "helper" / "mass").glob(f"*.{fmt}"))
    assert [p.name for p in port_files] == [p.name for p in jax_files] and len(port_files) == 3
    for p, j in zip(port_files, jax_files):
        if fmt == "npz":
            np.testing.assert_array_equal(dt.imread(p, device="cpu").img.numpy(), np.asarray(da.imread(j).img))
        else:
            assert p.read_bytes() == j.read_bytes()


def test_helper_cli_color_writes_the_histograms(workspace):
    work, configs = workspace
    user_interface_helper.main(["--config", str(configs["port", "npz"]), "--color"], device="cpu")
    assert (work / "results_port" / "helper" / "color_histograms.png").stat().st_size > 0
    reports = helper.helper_color(configs["port", "npz"], device="cpu")
    jax_reports = jax_helper.helper_color(configs["jax", "npz"], cls=da.Rig)
    np.testing.assert_allclose(reports[0]["LAB"]["mean"], jax_reports[0]["LAB"]["mean"], rtol=REPORT_TOL)


def test_helper_roi_snippet_against_jax(workspace, capsys):
    _, configs = workspace
    points = [[10, 20], [50, 70]]
    port = helper.helper_roi(configs["port", "npz"], points=points, device="cpu")
    port_out = capsys.readouterr().out
    jax = jax_helper_roi.helper_roi(configs["jax", "npz"], cls=da.Rig, points=points)
    assert port == jax and port_out == capsys.readouterr().out
    assert helper.format_roi_template([0.1, 0.2], [1.5, 0.9]) == jax_helper_roi.format_roi_template(
        [0.1, 0.2], [1.5, 0.9]
    )
    # Without points the corners are picked by hand (the SubregionAssistant,
    # item 7d), which needs a display, as in the JAX package.
    import matplotlib

    matplotlib.use("Agg")
    with pytest.raises(RuntimeError, match="SubregionAssistant requires an interactive"):
        helper.helper_roi(configs["port", "npz"], device="cpu")
    with pytest.raises(RuntimeError, match="SubregionAssistant requires an interactive"):
        jax_helper_roi.helper_roi(configs["jax", "npz"], cls=da.Rig)


def test_active_region_against_jax(workspace):
    _, configs = workspace
    config = dt.FluidFlowerConfig(configs["port", "npz"])
    data = np.random.default_rng(1).random((64, 96, 3)).astype(np.float32)
    image = dt.Image(torch.from_numpy(data), width=2.0, height=1.0)
    jax_image = da.Image(data, width=2.0, height=1.0)
    rois = config.roi_registry.resolve(["left"])
    mask = roi_visualization.build_active_mask_from_rois(rois, image)
    jax_mask = jax_roi.build_active_mask_from_rois(rois, jax_image)
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    assert 0 < mask.sum() < mask.numel()
    port = roi_visualization.render_active_region(image, mask)
    jax = jax_roi.render_active_region(jax_image, jax_mask)
    np.testing.assert_array_equal(port.image.numpy(), jax.image)
    np.testing.assert_array_equal(port.mask.numpy(), jax.mask)
    assert len(port.contours) == len(jax.contours) == 1
    np.testing.assert_array_equal(port.contours[0], jax.contours[0])
    whole = roi_visualization.render_active_region(torch.from_numpy(data[..., 0]))
    assert whole.contours == [] and whole.image.shape == (64, 96, 3)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    drawn = roi_visualization.draw_active_region(ax, image, mask, title="left")
    plt.close(fig)
    np.testing.assert_array_equal(drawn.image.numpy(), jax.image)


def test_without_opencv_media_and_contours_raise(workspace, monkeypatch):
    _, configs = workspace
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        user_interface_utils.main(["--config", str(configs["port", "npz"]), "--media"])
    mask = torch.zeros(8, 8, dtype=torch.bool)
    mask[2:5, 2:5] = True
    with pytest.raises(ImportError, match="OpenCV"):
        roi_visualization.render_active_region(torch.rand(8, 8, 3), mask)


def test_calibration_bundle_round_trip(workspace):
    """Export through the utils CLI, import into a second results folder:
    byte copies, as the JAX package makes them."""
    work, configs = workspace
    user_interface_utils.main(["--config", str(configs["port", "npz"]), "--export-calibration"], device="cpu")
    jax_utils.export_calibration_bundle(configs["jax", "npz"])

    def tree(root: Path) -> dict:
        return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}

    source = tree(work / "results_port" / "calibration" / "color")
    assert tree(work / "bundle_results_port") == source and len(source) == 4
    assert tree(work / "bundle_results_jax") == tree(work / "results_jax" / "calibration" / "color")
    target = configs["import", "npz"]
    assert utils.preview_calibration_bundle_import_conflicts(target) == []
    user_interface_utils.main(["--config", str(target), "--import-calibration"], device="cpu")
    assert tree(work / "results_import" / "calibration" / "color") == source
    conflicts = utils.preview_calibration_bundle_import_conflicts(target)
    assert conflicts == jax_utils.preview_calibration_bundle_import_conflicts(target) != []
    with pytest.raises(FileExistsError):
        utils.import_calibration_bundle(target)
    user_interface_utils.main(["--config", str(target), "--import-calibration", "--overwrite"])
    assert tree(work / "results_import" / "calibration" / "color") == source


def test_download_plan_against_jax(workspace, capsys):
    work, configs = workspace
    plan = utils.prepare_download_data(configs["port", "npz"])
    jax_plan = jax_utils.prepare_download_data(configs["jax", "npz"])
    assert plan.items and [p for p, _ in plan.items] == [p for p, _ in jax_plan.items]
    assert plan.total_size == jax_plan.total_size and plan.source == jax_plan.source
    user_interface_utils.main(["--config", str(configs["port", "npz"]), "--download-data", "--dry-run"])
    assert capsys.readouterr().out.strip() == plan.describe()
    assert not (work / "download_results_port").exists()
    copied = utils.download_data(configs["port", "npz"])
    for file, _ in copied.items:
        assert (work / "download_results_port" / file.name).read_bytes() == file.read_bytes()
    assert utils.prepare_download_data(configs["port", "npz"]).items == []


def test_load_images_with_cache(workspace, tmp_path):
    work, configs = workspace
    ctx = dt.presets.workflows.analysis.prepare_analysis_context(
        cls=dt.Rig, path=configs["port", "npz"], section="calibration", device="cpu"
    )
    rig = ctx.fluidflower
    reads = []
    read_image = rig.read_image
    rig.read_image = lambda path: reads.append(path) or read_image(path)
    first = utils.load_images_with_cache(rig, ctx.image_paths, use_cache=True, cache_dir=tmp_path)
    assert len(reads) == len(ctx.image_paths) == 3
    second = utils.load_images_with_cache(rig, ctx.image_paths, use_cache=True, cache_dir=tmp_path)
    assert len(reads) == 3
    for a, b in zip(first, second):
        assert b.img.device.type == "cpu"
        np.testing.assert_array_equal(a.img.numpy(), b.img.numpy())
        assert a.date == b.date
    plain = utils.load_images_with_cache(rig, ctx.image_paths[:1])
    assert len(reads) == 4
    np.testing.assert_array_equal(plain[0].img.numpy(), first[0].img.numpy())


@pytest.mark.parametrize(
    "port, jax",
    [
        (user_interface_helper.build_parser_for_helper, jax_helper_cli.build_parser_for_helper),
        (user_interface_utils.build_parser_for_utils, jax_utils_cli.build_parser_for_utils),
    ],
)
def test_parsers_match_the_jax_clis(port, jax):
    def summary(parser):
        return sorted((a.dest, a.default, a.nargs, a.required) for a in parser._actions)

    assert summary(port()) == summary(jax())
