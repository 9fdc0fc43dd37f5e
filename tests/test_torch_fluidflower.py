"""Parity of the port's FluidFlower CO2 and tracer analyses with the JAX
package, on the CPU.

The same seeded npz photographs and JSON configs go through
``darsia_tpu.FluidFlowerCO2Analysis`` and the port's (``device="cpu"``):
``tests/unit/test_fluidflower_presets.py``'s 60x100 scene, and the same
scene with 3 labels, a drift and a curvature section and a drifted probe
(per-label static thresholds for CO2, per-label dynamic Otsu for CO2(g)).
Tolerances: the CO2 and CO2(g) masks and the written segmentation ``.npy``
are equal (bitwise); cleaning filters written by one package are read by
the other.  The tracer preset: ``calibrate_balancing``'s scalings within
1e-5 relative; the concentration within 1e-6 (float32 values of order 1);
``calibrate_model`` on ``tests/unit/test_analysis_tools.py``'s scene within
1e-4 relative; the preset's ``calibrate_model`` faults (ROADMAP, reference
faults 20 and 21) raise alike.  ``FluidFlowerRig`` caches its labels.
"""

import json

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 60, 100
LAYERS = 3
# The curvature crop keeps the 2 : 1 aspect ratio: the corrected frame.
CROPPED = (W // 2, W)

COMMON = {
    "diff option": "absolute",
    "restoration -> model": True,
    "restoration resize": 0.5,
    "restoration method": "chambolle",
    "restoration weight": 0.05,
    "restoration max_num_iter": 30,
    "prior remove small objects size": 5,
    "prior fill holes size": 5,
    "prior resize": 0.5,
    "prior method": "chambolle",
    "prior weight": 0.05,
    "prior max_num_iter": 30,
    "posterior criterion": "value",
    "posterior threshold": 0.02,
}


def np_of(x) -> np.ndarray:
    x = x.img if hasattr(x, "img") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save(path, arr, width=2.0, height=1.0):
    da.Image(np.asarray(arr, np.float32), width=width, height=height, color_space="RGB").save(path)
    return path


def layer_labels(shape=(H, W)) -> np.ndarray:
    """Three wavy horizontal layers."""
    rows = np.arange(shape[0])[:, None]
    cols = np.arange(shape[1])[None, :]
    labels = np.zeros(shape, dtype=int)
    for k, amp in ((1, 3.0), (2, 2.0)):
        labels += rows >= k * shape[0] / LAYERS + amp * np.sin(2 * np.pi * cols / 47.0 + k)
    return labels


def scene(root, layered: bool):
    """Baseline and probe npz files (the probe drifted by (1, 2) px in the
    layered scene) and one JSON config per package (own cache files)."""
    rng = np.random.default_rng(0)
    base = np.full((H, W, 3), 0.55) + rng.normal(0, 0.005, (H, W, 3))
    if layered:
        base[..., 1] += 0.05 * layer_labels()
        base[:12, :20] = [0.9, 0.2, 0.1]  # a drift anchor
    img = base.copy()
    img[20:50, 20:70] += [-0.25, -0.1, 0.2]
    img[30:45, 35:55] += [-0.2, -0.15, 0.25]
    if layered:
        img = np.roll(img, (1, 2), axis=(0, 1))
    save(root / "base.npz", base)
    save(root / "img.npz", np.clip(img, 0, 1))
    configs = {}
    for name in ("jax", "port"):
        co2 = dict(COMMON, color="negative-key", cleaning_filter=str(root / name / "c1.npy"))
        gas = dict(COMMON, color="blue", cleaning_filter=str(root / name / "c2.npy"))
        if layered:
            co2["prior threshold value"] = [0.15, 0.12, 0.18]
            gas.update(
                {
                    "prior threshold dynamic": True,
                    "prior threshold method": "otsu",
                    "prior threshold value min": 0.1,
                    "prior threshold value max": 0.9,
                }
            )
        else:
            co2["prior threshold value"] = 0.15
            gas["prior threshold value"] = 0.3
        config = {
            "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
            "co2": co2,
            "co2(g)": gas,
        }
        if layered:
            config["drift"] = {"roi": [[0, 0], [24, 40]]}
            config["curvature"] = {
                "crop": {
                    "pts_src": [[1, 2], [H - 2, 1], [H - 1, W - 2], [2, W - 1]],
                    "width": 2.0,
                    "height": 1.0,
                },
                "bulge": {"horizontal_bulge": -1e-6, "vertical_bulge": -2e-6},
            }
        path = root / f"config_{name}.json"
        path.write_text(json.dumps(config))
        configs[name] = path
    return configs


def analysis_class(pkg, layered: bool):
    if not layered:
        return pkg.FluidFlowerCO2Analysis

    class Layered(pkg.FluidFlowerCO2Analysis):
        def __init__(self, *args, **kwargs):
            self.labels = layer_labels(CROPPED)
            super().__init__(*args, **kwargs)

    return Layered


def run_both(root, layered: bool):
    configs = scene(root, layered)
    out = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        analysis = analysis_class(pkg, layered)(
            baseline=root / "base.npz",
            config=configs[name],
            results=root / f"results_{name}",
            **extra,
        )
        co2, gas = analysis.single_image_analysis(root / "img.npz", write_segmentation_to_file=True)
        seg = np.load(root / f"results_{name}" / "npy_segmentation" / "img_segmentation.npy")
        out[name] = (np_of(co2).astype(bool), np_of(gas).astype(bool), seg, analysis)
    return out


@pytest.mark.parametrize("layered", [False, True], ids=["jax_scene", "labels_drift_curvature"])
def test_co2_analysis_matches_jax(tmp_path, layered):
    out = run_both(tmp_path, layered)
    (c_j, g_j, seg_j, _), (c_p, g_p, seg_p, analysis) = out["jax"], out["port"]
    assert analysis.base.img.device.type == "cpu"
    np.testing.assert_array_equal(c_p, c_j)
    np.testing.assert_array_equal(g_p, g_j)
    assert seg_p.dtype == seg_j.dtype
    np.testing.assert_array_equal(seg_p, seg_j)
    # The plume is found, the background is clean, and CO2(g) lies in CO2.
    r, c = (36, 47) if layered else (35, 45)
    assert c_p[r, c] and not c_p[5, 5 if not layered else 90]
    assert (~c_p & g_p).sum() == 0
    assert g_p.any()


def test_expert_knowledge_masking_matches_jax(tmp_path):
    configs = scene(tmp_path, layered=False)
    masks = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):

        class Constrained(pkg.FluidFlowerCO2Analysis):
            def _expert_knowledge_co2(self):
                mask = np.zeros((H, W), bool)
                mask[:, :50] = True  # the left half only
                return mask

        analysis = Constrained(
            baseline=tmp_path / "base.npz",
            config=configs[name],
            results=tmp_path / f"results_{name}",
            **extra,
        )
        analysis.load_and_process_image(tmp_path / "img.npz")
        co2 = analysis.determine_co2_mask()
        gas = analysis.determine_co2_gas_mask(co2)
        masks[name] = (np_of(co2).astype(bool), np_of(gas).astype(bool))
    assert not masks["port"][0][:, 50:].any()
    for port, ref in zip(masks["port"], masks["jax"]):
        np.testing.assert_array_equal(port, ref)


def test_gas_stays_inside_co2_after_the_clean_up(tmp_path):
    """Reference fault 22, repaired in the port: with holes in the CO2 mask
    under the gas core, the JAX package's clean-up after masking fills them,
    so its CO2(g) leaks out of CO2; the port's CO2(g) is the JAX package's
    within CO2."""
    configs = scene(tmp_path, layered=False)
    masks = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        analysis = pkg.FluidFlowerCO2Analysis(
            baseline=tmp_path / "base.npz", config=configs[name], results=tmp_path / f"r_{name}", **extra
        )
        analysis.load_and_process_image(tmp_path / "img.npz")
        co2 = analysis.determine_co2_mask()
        holes = np_of(co2).astype(bool).copy()
        holes[34:42:3, 38:52:3] = False  # single-pixel holes under the gas core
        co2.img = torch.from_numpy(holes) if pkg is dt else holes
        masks[name] = (holes, np_of(analysis.determine_co2_gas_mask(co2)).astype(bool))
    holes, gas_j = masks["jax"]
    gas_p = masks["port"][1]
    assert (gas_j & ~holes).sum() > 0  # the JAX package's leak
    assert (gas_p & ~holes).sum() == 0
    np.testing.assert_array_equal(gas_p, gas_j & holes)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cleaning_filter_files_are_shared(tmp_path, writer):
    """A filter learnt from two baselines and written by one package is read
    by the other: the same file, the same maps."""
    configs = scene(tmp_path, layered=False)
    rng = np.random.default_rng(3)
    base2 = np.clip(np.full((H, W, 3), 0.55) + rng.normal(0, 0.02, (H, W, 3)), 0, 1)
    save(tmp_path / "base2.npz", base2)
    baselines = [tmp_path / "base.npz", tmp_path / "base2.npz"]
    reader = "port" if writer == "jax" else "jax"
    pkgs = {"jax": (da, {}), "port": (dt, {"device": "cpu"})}
    config = json.loads(configs[writer].read_text())
    configs[reader].write_text(json.dumps(config))  # the writer's cache files

    written = {}
    for role, name in (("writer", writer), ("reader", reader)):
        pkg, extra = pkgs[name]
        analysis = pkg.FluidFlowerCO2Analysis(
            baseline=baselines, config=configs[name], results=tmp_path / f"r_{name}", **extra
        )
        filt = np_of(analysis.co2_analysis.threshold_cleaning_filter)
        co2, gas = analysis.single_image_analysis(tmp_path / "img.npz")
        written[role] = (filt, np_of(co2).astype(bool), np_of(gas).astype(bool))
        if role == "writer":
            on_disk = np.load(config["co2"]["cleaning_filter"])
            np.testing.assert_array_equal(on_disk, filt)
    assert written["writer"][0].max() > 0
    for port, ref in zip(written["reader"], written["writer"]):
        np.testing.assert_array_equal(port, ref)


# ----------------------------------------------------------------- tracer

TRACER = {
    "color": "gray",
    "diff option": "absolute",
    "restoration resize": 0.5,
    "restoration method": "chambolle",
    "restoration weight": 0.05,
    "restoration max_num_iter": 20,
    "model scaling": 3.0,
}


def tracer_scene(root):
    """A layered baseline whose layers take a tracer with different
    contrast, and two photographs of a growing plume."""
    rng = np.random.default_rng(1)
    labels = layer_labels()
    base = np.full((H, W, 3), 0.5) + rng.normal(0, 0.003, (H, W, 3))
    save(root / "base.npz", base)
    gains = np.array([1.0, 0.7, 1.3])[labels][..., None]
    paths = []
    for k, width in enumerate((40, 70)):
        img = base.copy()
        img[:, 10 : 10 + width] += 0.2 * gains[:, 10 : 10 + width]
        paths.append(save(root / f"tracer_{k}.npz", np.clip(img, 0, 1)))
    configs = {}
    for name in ("jax", "port"):
        config = {
            "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
            "tracer": dict(TRACER, cleaning_filter=str(root / name / "tracer.npy")),
        }
        configs[name] = root / f"tracer_{name}.json"
        configs[name].write_text(json.dumps(config))
    return labels, paths, configs


def tracer_class(pkg, labels, geometry=None):
    class Layered(pkg.FluidFlowerTracerAnalysis):
        def __init__(self, *args, **kwargs):
            self.labels = labels
            if geometry is not None:
                self.geometry = geometry
            super().__init__(*args, **kwargs)

    return Layered


def test_tracer_balancing_and_concentration_match_jax(tmp_path):
    labels, paths, configs = tracer_scene(tmp_path)
    out = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        analysis = tracer_class(pkg, labels)(
            tmp_path / "base.npz", configs[name], tmp_path / f"res_{name}", **extra
        )
        analysis.calibrate_balancing(paths, {"labels": labels, "balancing_dofs": ["scaling"]})
        scaling = np.asarray(analysis.tracer_analysis.balancing._scaling)
        concentration = np_of(analysis.single_image_analysis(paths[1]))
        out[name] = (scaling, concentration)
    (s_j, c_j), (s_p, c_p) = out["jax"], out["port"]
    # The layers' contrast, undone: the scalings are about 1, 1/0.7, 1/1.3.
    np.testing.assert_allclose(s_j, [1.0, 1 / 0.7, 1 / 1.3], rtol=0.1)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5)
    assert np.abs(c_p - c_j).max() <= 1e-6


def test_tracer_calibrate_model_faults_are_mirrored(tmp_path):
    """The preset's calibrate_model reads self.geometry, which no class sets
    (fault 20); with a geometry set by a subclass it meets the model
    calibration's restoration -> model assertion (fault 21)."""
    labels, paths, configs = tracer_scene(tmp_path)
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        options = {"initial_guess": [1.0], "injection_rate": 0.1, "dofs": ["scaling"]}
        plain = tracer_class(pkg, labels)(
            tmp_path / "base.npz", configs[name], tmp_path / f"res_{name}", **extra
        )
        with pytest.raises(AttributeError, match="geometry"):
            plain.calibrate_model(paths, options)
        geometry = pkg.Geometry(space_dim=2, num_voxels=(H, W), dimensions=[1.0, 2.0])
        with_geometry = tracer_class(pkg, labels, geometry)(
            tmp_path / "base.npz", configs[name], tmp_path / f"res_{name}", **extra
        )
        with pytest.raises(AssertionError, match="restoration -> model"):
            with_geometry.calibrate_model(paths, options)


def test_tracer_calibrate_model_with_a_geometry_matches_jax(tmp_path):
    """A subclass that sets a geometry and orders restoration before the
    model: the injection-rate calibration of the preset's model (linear
    scaling and offset, then the clip's bounds: dofs "all") runs in both
    packages alike."""
    labels, paths, configs = tracer_scene(tmp_path)
    params = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        geometry = pkg.Geometry(space_dim=2, num_voxels=(H, W), dimensions=[1.0, 2.0])

        class Calibrated(tracer_class(pkg, labels, geometry)):
            def define_tracer_analysis(self):
                analysis = super().define_tracer_analysis()
                analysis.first_restoration_then_model = True
                return analysis

        analysis = Calibrated(tmp_path / "base.npz", configs[name], tmp_path / f"res_{name}", **extra)
        timed = []
        for k, path in enumerate(paths):
            img = pkg.imread(path, **extra)
            img.time = float(k + 1)
            timed.append(tmp_path / f"timed_{name}_{k}.npz")
            img.save(timed[-1])
        analysis.calibrate_model(
            timed,
            {
                "initial_guess": np.array([3.0, 0.0, 0.0, 1.0]),
                "injection_rate": 0.05,
                "regression_type": "linear",
                "method": "Nelder-Mead",
                "maxiter": 60,
            },
        )
        linear, clip = analysis.tracer_analysis.model.models
        params[name] = np.array(
            [linear._scaling, linear._offset, clip._min_value, clip._max_value], dtype=float
        )
    assert abs(params["jax"][0] - 3.0) > 1e-3  # the calibration moved the scaling
    np.testing.assert_allclose(params["port"], params["jax"], rtol=1e-4, atol=1e-6)


# -------------------------------------------------------------------- rig


def test_rig_segments_and_caches_its_labels(tmp_path):
    """tests/unit/test_fluidflower_presets.py's two-layer rig: the port
    segments as the JAX package does, caches the labels, and reads the
    cache the JAX package wrote."""
    arr = np.full((40, 60, 3), 0.3)
    arr[20:] = 0.7
    save(tmp_path / "base.npz", arr)
    labels = {}
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        config = {
            "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
            "segmentation": {
                "labels_path": str(tmp_path / name / "labels.npy"),
                "marker_points": [[10, 30], [30, 30]],
            },
        }
        path = tmp_path / f"rig_{name}.json"
        path.write_text(json.dumps(config))
        rig = pkg.FluidFlowerRig(tmp_path / "base.npz", path, **extra)
        assert (tmp_path / name / "labels.npy").exists()
        again = pkg.FluidFlowerRig(tmp_path / "base.npz", path, **extra)
        np.testing.assert_array_equal(again.labels, rig.labels)
        assert rig._labels_to_mask([int(rig.labels[5, 5])])[5, 5]
        labels[name] = np.asarray(rig.labels)
    np.testing.assert_array_equal(labels["port"], labels["jax"])
    assert len(np.unique(labels["port"])) == 2
    # The port reads the JAX package's cache.
    config = json.loads((tmp_path / "rig_jax.json").read_text())
    (tmp_path / "rig_cross.json").write_text(json.dumps(config))
    cached = dt.FluidFlowerRig(tmp_path / "base.npz", tmp_path / "rig_cross.json", device="cpu")
    np.testing.assert_array_equal(cached.labels, labels["jax"])
