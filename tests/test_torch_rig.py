"""The port's rig workflow against the JAX package, from one TOML config.

The assets of ``tests/unit/test_rig_presets.py`` (a seeded baseline, two
labels, a depth, facies properties), made into a TOML config at 96x128: the
baseline and two drifted photographs with a painted plume as ``.npz`` files,
a coloured sketch of three layers, ~20 seeded depth measurements, imaging,
injection and pressure/temperature protocols, and the corrections drift and
colour on a painted 4x6 checker, curvature and illumination.  Each package
runs ``setup_depth_map``, ``segment_colored_image`` and ``setup_rig`` on its
own copy of the config (the port on the CPU); the rigs are compared, each
package loads the other's saved folder, and both read the same photographs.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.analysis.porosity import PorosityAnalysis as JaxPorosityAnalysis
from darsia_tpu.presets.workflows import setup as jax_setup
from darsia_tpu.restoration.averaging import porosity_based_averaging as jax_averaging
from darsia_tpu_torch.presets.workflows import setup

torch.set_num_threads(1)

H, W, PX, CHECKER_AT = 96, 128, 8, (6, 72)
META = {"width": 1.4, "height": 1.05}
SHIFTS = [(0, 0), (1, 2), (2, -1)]
#: Depth maps: the JAX thin-plate spline is float32, the port's float64
#: (tests/test_torch_color_corrections.py's SCALING_REL_TOL, relative).
DEPTH_REL_TOL = 1e-4
#: Images through the illumination correction: its scaling field is fitted
#: in float32 by the JAX package and in float64 by the port (the same
#: tolerance, relative to the largest value).
READ_REL_TOL = 1e-4
#: The port's kernel interpolation against a float64 numpy reckoning of the
#: JAX package's calibration on the same baseline (ROADMAP.md Queue 3,
#: reference fault 23).
POROSITY_TOL = 1e-6

CURVATURE = """
[corrections.curvature.config.crop]
pts_src = [[2, 3], [93, 2], [94, 124], [3, 126]]
width = 1.4
height = 1.05

[corrections.curvature.config.bulge]
horizontal_bulge = 1e-6
vertical_bulge = 2e-6
"""


def _frame(shift, plume: bool) -> np.ndarray:
    rng = np.random.default_rng(0)
    frame = rng.uniform(0.3, 0.6, size=(H, W, 3)) * (0.85 + 0.3 * np.arange(W) / W)[None, :, None]
    r0, c0 = CHECKER_AT
    swatches = da.ColorCheckerAfter2014().swatches_rgb
    frame[r0 : r0 + 4 * PX, c0 : c0 + 6 * PX] = np.kron(swatches, np.ones((PX, PX, 1)))
    if plume:
        yy, xx = np.mgrid[0:H, 0:W]
        inside = ((yy - 62) / 16) ** 2 + ((xx - 40) / 26) ** 2 < 1
        frame[inside] *= np.array([0.6, 0.9, 1.2])
    return np.roll((np.clip(frame, 0, 1) * 255).astype(np.uint8), shift, axis=(0, 1))


def _write_config(root: Path, name: str, porosity_mode: str) -> Path:
    results = root / f"results_{name}"
    text = f"""
[data]
folder = "{root / 'images'}"
baseline = "img_00000.npz"
results = "{results}"

[rig]
width = {META['width']}
height = {META['height']}
dim = 2
resolution = [{H}, {W}]

[depth]
measurements = "{root / 'depth.csv'}"

[labeling]
colored_image = "{root / 'sketch.npz'}"

[facies]
props = "{root / 'facies.csv'}"

[protocols]
imaging = "{root / 'imaging.csv'}"
injection = "{root / 'injection.csv'}"
pressure_temperature = "{root / 'pressure_temperature.csv'}"

[image_porosity]
mode = "{porosity_mode}"
tol = 0.2
sample_width = 12
num_clusters = 3

[corrections.drift]
colorchecker = "upper_right"

[corrections.color]
colorchecker = "upper_right"

[corrections.illumination]
width = 12
num_samples = 10
interpolation = "quartic"
{CURVATURE}"""
    path = root / f"config_{name}.toml"
    path.write_text(text)
    return path


def _write_assets(root: Path) -> None:
    (root / "images").mkdir()
    for i, shift in enumerate(SHIFTS):
        da.OpticalImage(_frame(shift, i > 0), **META).save(root / "images" / f"img_{i:05d}.npz")
    sketch = np.zeros((H, W, 3), np.float32)
    sketch[:30] = [1.0, 0.0, 0.0]
    sketch[30:64] = [0.0, 1.0, 0.0]
    sketch[64:] = [0.0, 0.0, 1.0]
    da.OpticalImage(sketch, **META).save(root / "sketch.npz")
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, META["width"], 20), rng.uniform(0, META["height"], 20)
    depth = 0.02 + 0.004 * np.sin(2 * x) * np.cos(3 * y)
    (root / "depth.csv").write_text(
        "x,y,mean\n" + "".join(f"{a},{b},{c}\n" for a, b, c in zip(x.tolist(), y.tolist(), depth.tolist()))
    )
    (root / "facies.csv").write_text(
        "id,porosity,permeability\n0,0.44,2e-10\n1,0.36,9e-11\n2,0.40,1e-10\n"
    )
    (root / "imaging.csv").write_text(
        "path,image_id,datetime\n"
        + "".join(f"img_{i:05d}.npz,{i},2024-03-01 {9 + i:02d}:00:00\n" for i in range(len(SHIFTS)))
    )
    (root / "injection.csv").write_text(
        "id,location_x,location_y,start,end,rate_kg/s\n"
        "1,0.5,0.3,2024-03-01 09:30:00,2024-03-01 12:00:00,1e-6\n"
    )
    (root / "pressure_temperature.csv").write_text(
        "datetime,pressure_bar,temperature_celsius\n"
        "2024-03-01 09:00:00,1.013,20.0\n2024-03-01 12:00:00,1.02,21.5\n"
    )


def _set_up(config: Path, port: bool):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if port:
            setup.setup_depth_map(config, device="cpu")
            setup.segment_colored_image(config, device="cpu")
            return setup.setup_rig(dt.Rig, config, device="cpu")
        jax_setup.setup_depth_map(config)
        jax_setup.segment_colored_image(config)
        return jax_setup.setup_rig(da.Rig, config)


@pytest.fixture(scope="module", params=["from_image", "full"])
def rigs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("rig")
    _write_assets(root)
    configs = {name: _write_config(root, name, request.param) for name in ("jax", "port")}
    return {
        "root": root,
        "mode": request.param,
        "configs": configs,
        "jax": _set_up(configs["jax"], port=False),
        "port": _set_up(configs["port"], port=True),
    }


def _np(image) -> np.ndarray:
    return image.img.numpy() if isinstance(image.img, torch.Tensor) else np.asarray(image.img)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_setup_rig_against_jax(rigs):
    j, t = rigs["jax"], rigs["port"]
    assert t.device == torch.device("cpu") and t.baseline.img.device.type == "cpu"
    assert [type(c).__name__ for c in t.corrections] == [type(c).__name__ for c in j.corrections] == [
        "Resize",
        "DriftCorrection",
        "CurvatureCorrection",
        "IlluminationCorrection",
        "ColorCorrection",
    ]
    np.testing.assert_array_equal(_np(t.labels), _np(j.labels))
    assert sorted(np.unique(_np(t.labels)).tolist()) == [0, 1, 2]
    np.testing.assert_array_equal(_np(t.inner_labels), _np(j.inner_labels))
    np.testing.assert_array_equal(_np(t.facies), _np(j.facies))
    for field in ("porosity", "permeability"):
        np.testing.assert_array_equal(_np(getattr(t, field)), _np(getattr(j, field)))
    assert _rel(_np(t.depth), _np(j.depth)) <= DEPTH_REL_TOL
    assert _np(t.shape_corrected_baseline).shape == _np(j.shape_corrected_baseline).shape
    assert np.abs(_np(t.shape_corrected_baseline) - _np(j.shape_corrected_baseline)).max() <= 1e-5
    assert _rel(_np(t.baseline), _np(j.baseline)) <= READ_REL_TOL
    assert type(t.geometry).__name__ == "ExtrudedPorousGeometry"


def test_image_porosity_and_averaging(rigs):
    j, t = rigs["jax"], rigs["port"]
    porosity = _np(t.image_porosity)
    assert porosity.dtype == np.float32 and porosity.shape == (H, W)
    assert porosity.min() >= 0 and porosity.max() <= 1
    if rigs["mode"] == "full":
        assert np.all(porosity == 1) and np.all(_np(j.image_porosity) == 1)
    else:
        # The JAX package's calibration on the port's baseline, evaluated in
        # float64 (its own float32 evaluation is rounding noise here).
        base = _np(t.baseline)
        labels = _np(t.labels)
        model = JaxPorosityAnalysis(
            da.OpticalImage(base, **META),
            labels=da.Image(labels, scalar=True, **META),
            num_clusters=3,
            sample_width=12,
        ).model[0]
        want = np.zeros((H, W))
        for label in np.unique(labels):
            kernel = model[label]
            s, v = np.asarray(kernel.supports, float), np.asarray(kernel.values, float)
            x = np.exp(-np.sum((s[:, None] - s[None]) ** 2, -1))
            w = np.linalg.inv(x + 1e-8 * np.trace(x) / len(s) * np.eye(len(s))) @ v
            k = np.exp(-np.sum((base.reshape(-1, 1, 3).astype(float) - s[None]) ** 2, -1))
            want[labels == label] = (k @ w).reshape(H, W)[labels == label]
        assert np.abs(porosity - np.clip(want, 0, 1)).max() <= POROSITY_TOL
        assert 0 < porosity.mean() < 1
    tol = _np(t.image_porosity) > 0.2
    np.testing.assert_array_equal(_np(t.boolean_porosity), tol)
    # The averaging, against the JAX one built from the same fields.
    field = np.random.default_rng(4).random((H, W)).astype(np.float32)
    ref = jax_averaging(
        da.Image(_np(t.labels), scalar=True, **META),
        da.Image(porosity, scalar=True, **META),
        da.OpticalImage(_np(t.baseline), **META),
    )
    got = t.restoration(dt.ScalarImage(torch.from_numpy(field), device="cpu", **META))
    want = ref(da.ScalarImage(field, **META))
    assert np.abs(_np(got) - _np(want)).max() <= 1e-6


def test_read_image_against_jax(rigs):
    j, t = rigs["jax"], rigs["port"]
    for i in (1, 2):
        path = rigs["root"] / "images" / f"img_{i:05d}.npz"
        a, b = _np(j.read_image(path)), _np(t.read_image(path))
        assert b.dtype == np.float32 and b.shape == a.shape and np.isfinite(b).all()
        assert _rel(b, a) <= READ_REL_TOL
        t_img = t.read_image(path)
        assert t_img.name == path.name and t_img.date.hour == 9 + i


def test_saved_folders_read_both_ways(rigs, tmp_path):
    j, t = rigs["jax"], rigs["port"]
    path = rigs["root"] / "images" / "img_00001.npz"
    j.save(tmp_path / "jax_rig")
    loaded = dt.Rig.load(tmp_path / "jax_rig", device="cpu")
    loaded.load_experiment(t.experiment)
    assert [type(c).__name__ for c in loaded.corrections] == [type(c).__name__ for c in j.corrections]
    np.testing.assert_array_equal(_np(loaded.baseline), _np(j.baseline))
    np.testing.assert_array_equal(_np(loaded.labels), _np(j.labels))
    np.testing.assert_array_equal(_np(loaded.image_porosity), _np(j.image_porosity))
    assert _rel(_np(loaded.read_image(path)), _np(j.read_image(path))) <= READ_REL_TOL
    # The port's folder, read by both packages.
    t.save(tmp_path / "port_rig")
    back = dt.Rig.load(tmp_path / "port_rig", device="cpu")
    back.load_experiment(t.experiment)
    np.testing.assert_array_equal(_np(back.read_image(path)), _np(t.read_image(path)))
    j_back = da.Rig.load(tmp_path / "port_rig")
    j_back.load_experiment(j.experiment)
    np.testing.assert_array_equal(np.asarray(j_back.baseline.img), _np(t.baseline))
    assert _rel(np.asarray(j_back.read_image(path).img), _np(t.read_image(path))) <= READ_REL_TOL


def test_update_and_mass_analysis_wiring(rigs):
    j, t = rigs["jax"], rigs["port"]
    path = rigs["root"] / "images" / "img_00002.npz"
    for rig in (j, t):
        rig.load_experiment(rig.experiment)
        rig.update(path)
    assert t.current_time == j.current_time == 1.5  # hours since the injection start
    assert t.current_pressure == pytest.approx(j.current_pressure, abs=0)
    assert t.current_temperature == pytest.approx(j.current_temperature, abs=0)
    mass = t.co2_mass_analysis
    assert type(mass).__name__ == "CO2MassAnalysis" and mass.baseline is t.baseline
    assert mass.atmospheric_pressure == j.co2_mass_analysis.atmospheric_pressure
    # The prefetching reader yields what read_image reads.
    ((read_path, image),) = list(t.read_images([path]))
    ((_, jax_image),) = list(j.read_images([path]))
    assert read_path == path and torch.equal(image.img, t.read_image(path).img)
    assert _rel(_np(image), np.asarray(jax_image.img)) <= READ_REL_TOL


def test_import_from_csv_against_jax(rigs, tmp_path):
    xs, ys = np.meshgrid(np.linspace(0.05, 1.35, 14), np.linspace(0.05, 1.0, 10))
    rows = np.stack([xs.ravel(), ys.ravel(), np.sin(xs).ravel() + ys.ravel()], axis=1)
    np.random.default_rng(0).shuffle(rows)
    csv = tmp_path / "values.csv"
    np.savetxt(csv, rows, delimiter=",", header="x,y,value", comments="")
    a = rigs["jax"].import_from_csv(csv, name="v")
    b = rigs["port"].import_from_csv(csv, name="v")
    assert b.img.device.type == "cpu" and b.name == "v"
    np.testing.assert_allclose(b.img.numpy(), np.asarray(a.img), rtol=0, atol=1e-7)
    np.testing.assert_allclose(b.origin, np.asarray(a.origin), atol=1e-12)


def test_porosity_label_missed_by_the_shared_patches():
    """Reference fault 25: the JAX package samples every label with one set
    of patches; a label none of them touches fails its image patch, written
    as porosity 1.  The port samples that label on its own pixels: no
    warning, and every label's calibration equals JAX's characteristic
    colours of the same patches (float64 reckoning as above)."""
    from darsia_tpu.utils.box import random_patches as jax_random_patches
    from darsia_tpu.utils.extractcharacteristicdata import extract_characteristic_data as jax_extract

    rng = np.random.default_rng(6)
    base = rng.uniform(0.2, 0.7, size=(64, 96, 3)).astype(np.float32)
    shared = jax_random_patches((64, 96), width=12, num_patches=10, rng=np.random.default_rng(42))
    covered = np.zeros(64, bool)
    for rows, _ in shared:
        covered[rows] = True
    labels = np.zeros((64, 96), np.int32)
    labels[np.flatnonzero(~covered)[:4]] = 1  # rows no shared patch reaches
    assert (labels == 1).any()
    kw = dict(num_clusters=3, sample_width=12)
    with pytest.warns(UserWarning, match="Porosity analysis failed"):
        j = da.presets.analysis.porosity.patched_porosity_analysis(
            da.OpticalImage(base, **META), labels=da.Image(labels, scalar=True, **META), **kw
        )
    assert np.all(np.asarray(j.img) == 1.0)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="Porosity analysis failed")
        analysis = dt.PorosityAnalysis(
            dt.OpticalImage(torch.from_numpy(base), **META),
            labels=dt.Image(torch.from_numpy(labels), scalar=True, **META),
            **kw,
        )
    assert analysis.samples_per_label[0] == shared and analysis.samples_per_label[1] != shared
    for rows, cols in analysis.samples_per_label[1]:
        assert (labels[rows, cols] == 1).any()
    got = analysis(dt.OpticalImage(torch.from_numpy(base), **META)).img.numpy()
    want = np.zeros((64, 96))
    gradient = np.sqrt(sum(np.gradient(base[..., i].astype(float), axis=a) ** 2 for i in range(3) for a in range(2)))
    for label in (0, 1):
        mask = labels == label
        _, palettes = jax_extract(
            base.astype(float), mask=mask, samples=analysis.samples_per_label[label], num_clusters=3,
            num_attempts=10, num_iterations=100, eps=1e-2, mode="all",
        )
        s, v = [], []
        for palette, cluster_labels in zip(palettes, _):
            dominant = palette[int(np.argmax(np.bincount(np.asarray(cluster_labels).ravel(), minlength=len(palette))))]
            for center in palette:
                d = float(np.linalg.norm(center - dominant))
                flat = gradient[mask].sum() / mask.sum() < 0.02
                s.append(center)
                v.append(1.0 if d < 0.1 or flat else float(np.clip(1.0 - d / 0.2, 0, 1)))
        s, idx = np.unique(np.round(np.asarray(s, np.float32), 5), return_index=True, axis=0)
        s, v = s.astype(float), np.asarray(v)[idx]
        x = np.exp(-np.sum((s[:, None] - s[None]) ** 2, -1))
        w = np.linalg.inv(x + 1e-8 * np.trace(x) / len(s) * np.eye(len(s))) @ v
        k = np.exp(-np.sum((base.reshape(-1, 1, 3).astype(float) - s[None]) ** 2, -1))
        want[mask] = (k @ w).reshape(64, 96)[mask]
    assert np.abs(got - np.clip(want, 0, 1)).max() <= POROSITY_TOL


def test_setup_facies_and_delete_rig_against_jax(tmp_path):
    """``setup_facies`` maps labels to facies by the config's table and
    checks them against the properties' CSV (read without pandas); the
    facies maps of both packages are equal, a facies missing from the CSV
    raises in both, and ``delete_rig`` removes the rig folder."""
    _write_assets(tmp_path)
    facies = "\n[facies.facies_to_labels]\n0 = [0]\n1 = [1, 2]\n"
    configs = {}
    for name in ("jax", "port"):
        path = _write_config(tmp_path, name, "full")
        path.write_text(path.read_text() + facies)
        configs[name] = path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_setup.segment_colored_image(configs["jax"])
        setup.segment_colored_image(configs["port"], device="cpu")
        j = jax_setup.setup_facies(configs["jax"])
        t = setup.setup_facies(configs["port"], device="cpu")
        np.testing.assert_array_equal(_np(t), _np(j))
        assert sorted(np.unique(_np(t)).tolist()) == [0, 1]
        loaded = dt.imread(tmp_path / "results_port" / "setup" / "facies.npz", device="cpu")
        np.testing.assert_array_equal(_np(loaded), _np(j))
        (tmp_path / "facies.csv").write_text("id,porosity,permeability\n0,0.44,2e-10\n")
        for run in (lambda: jax_setup.setup_facies(configs["jax"]), lambda: setup.setup_facies(configs["port"], device="cpu")):
            with pytest.raises(ValueError, match="Facies id 1 not found"):
                run()
        rig_folder = tmp_path / "results_port" / "setup" / "rig"
        rig_folder.mkdir(parents=True)
        assert setup.delete_rig(configs["port"]) and not rig_folder.exists()
        assert not setup.delete_rig(configs["port"])
