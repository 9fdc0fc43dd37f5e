"""The port imports and runs with JAX and OpenCV absent.

A subprocess blocks ``jax`` and ``cv2``, and the display and export layer's
libraries (matplotlib, plotly, pydicom, meshio, pandas), as
``sys.modules[name] = None`` (any import of them fails), imports
``darsia_tpu_torch`` and runs the small correct -> register -> concentrate
pipeline on a numpy-made frame.  It also imports every module of the
package and runs the heterogeneous colour-to-mass chain, a W1 solve and its
VTK export (which needs no library), the FluidFlower CO2 analysis and rig from
a numpy-made JSON config and npz frames, the rig workflow from a TOML
config (set-up steps without matplotlib warn and write their .npz), the
colour-path regression and the colour report (the active region's contours
raise, naming OpenCV).  A second subprocess also
blocks ``darsia_tpu`` and reads the image, every correction file, a
colour-to-mass calibration folder, and the cleaning filters and labels cache
of a FluidFlower CO2 analysis and rig that the JAX package wrote beforehand
in this process.
"""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "cv2", "pandas", "matplotlib", "plotly", "pydicom", "meshio"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])

import numpy as np
import torch
from scipy.ndimage import uniform_filter

torch.set_num_threads(1)
import darsia_tpu_torch as dt

assert not any(m == "darsia_tpu" or m.startswith("darsia_tpu.") for m in sys.modules)

rng = np.random.default_rng(0)
H, W = 64, 80
layers = [uniform_filter(rng.random((H, W)), 5) for _ in range(3)]
base = np.stack([(l - l.min()) / (l.max() - l.min()) for l in layers], -1)
base_u8 = (base * 255).astype(np.uint8)
probe = np.roll(base_u8, (1, 2), axis=(0, 1))

curv = dt.CurvatureCorrection(config={
    "crop": {"pts_src": [[2, 3], [H - 4, 2], [H - 3, W - 3], [2, W - 4]],
             "width": 1.0, "height": 1.0},
    "bulge": {"horizontal_bulge": -1e-7, "vertical_bulge": -2e-7},
})
trans = dt.TranslationCorrection([1.0, -2.0])
meta = {"width": 1.0, "height": 1.0}
base_img = dt.OpticalImage(torch.from_numpy(base_u8), transformations=[trans, curv],
                           **meta).img_as(torch.float32)
analysis = dt.ConcentrationAnalysis(
    base=base_img,
    signal_reduction=dt.MonochromaticReduction(color="gray"),
    restoration=lambda s: dt.H1_regularization(s, mu=1.0, omega=0.2, solver=dt.Jacobi(maxiter=5)),
    model=dt.LinearModel(scaling=2.0),
    **{"diff option": "positive"},
)
reg = dt.ImageRegistration(base_img, N_patches=[2, 2], rel_overlap=0.2, quality_tol=0.01)
pipe = dt.FusedAnalysisPipeline(transformations=[trans, curv], registration=reg,
                                analysis=analysis)
out = pipe(torch.from_numpy(probe))
assert out.img.shape == tuple(base_img.num_voxels), out.img.shape
assert torch.isfinite(out.img).all()

# The interpolant of the frame's staged shifts, a flexible and a multiscale
# registration, a subregion and a 2-frame series correction.
field = reg.displacement()
assert field.shape == (2,) + tuple(base_img.num_voxels) and torch.isfinite(field).all()
probe_img = dt.OpticalImage(torch.from_numpy(probe), transformations=[trans, curv],
                            **meta).img_as(torch.float32)
for kw in ({"fused": False}, {"num_levels": 2}):
    flex = dt.ImageRegistration(base_img, N_patches=[2, 2], rel_overlap=0.2, quality_tol=0.01, **kw)
    aligned = flex(probe_img)
    assert aligned.img.shape == base_img.img.shape and torch.isfinite(aligned.img).all()
    assert np.isfinite(flex.evaluate([[0.5, 0.5]], units="metric")).all()
sub = base_img.subregion(dt.make_coordinate([[0.1, 0.9], [0.6, 0.2]]))
assert sub.img.shape[2] == 3 and sub.dimensions[1] > 0
series = np.stack([base_u8, probe], axis=2)
corrected = dt.OpticalImage(torch.from_numpy(series), transformations=[trans, curv],
                            series=True, time=[0.0, 1.0], **meta)
assert corrected.img.shape[2] == 2 and corrected.img.shape[:2] == base_img.img.shape[:2]

# The rig's correction workflow: a checker found on a noise frame, drift
# fused into the curvature warp, illumination and color corrections, a
# drifting series, and the corrections saved and read back.
import tempfile
from pathlib import Path
from types import SimpleNamespace

ref = dt.ColorCheckerAfter2014().swatches_rgb
rig = (rng.random((240, 400, 3)) * 255).astype(np.uint8)
rig[20:100, 250:370] = (np.kron(ref, np.ones((20, 20, 1))) * 255).astype(np.uint8)
rig_t = torch.from_numpy(rig)
_, voxels = dt.find_colorchecker(rig_t)
drift = dt.DriftCorrection(rig_t, {"roi": voxels})
rig_curv = dt.CurvatureCorrection(config={"bulge": {"vertical_bulge": -1e-7}})
shape = [dt.Resize(shape=(240, 400)), drift, rig_curv]
corrected_base = dt.OpticalImage(rig_t, transformations=shape, width=2.0, height=1.2)
illum = dt.IlluminationCorrection()
cfg = SimpleNamespace(width=20, num_samples=8, seed=42)
samples = illum.select_random_samples(np.ones((240, 400), bool), cfg)
illum.setup(corrected_base, [samples], outliers=0.1, interpolation="illumination")
color = dt.ColorCorrection(corrected_base, {"roi": voxels, "clip": False})
probe_rig = torch.from_numpy(np.roll(rig, (2, 3), axis=(0, 1)))
read = dt.OpticalImage(probe_rig, transformations=shape + [illum, color], width=2.0, height=1.2)
assert read.img.shape == (240, 400, 3) and torch.isfinite(read.img).all()
assert (drift.pullback_translation(probe_rig) - torch.tensor([2.0, 3.0])).abs().max() < 0.1
drifting = torch.stack([torch.roll(rig_t, (k, -k), (0, 1)) for k in range(3)], dim=2)
series_out = dt.OpticalImage(drifting, transformations=[drift, rig_curv], series=True, time=[0.0, 1.0, 2.0])
assert series_out.img.shape == (240, 400, 3, 3)
with tempfile.TemporaryDirectory() as tmp:
    for k, corr in enumerate(shape + [illum, color, dt.TypeCorrection(np.float32)]):
        corr.save(Path(tmp) / f"c{k}")
        assert type(dt.read_correction(Path(tmp) / f"c{k}.npz")) is type(corr)

# The rest of the correction registry, patches and the saved rig state.
small = corrected_base.subregion((slice(0, 96), slice(0, 128)))
cs = small.coordinatesystem
src = dt.make_coordinate(cs.coordinate(rng.random((5, 2)) * [96, 128]))
affine = dt.AffineCorrection(cs, cs, src, dt.make_coordinate(np.asarray(src) + 0.01))
rotation = dt.RotationCorrection([48, 64], rotations=[0.01])
perspective = dt.GeneralizedPerspectiveCorrection(
    cs, cs, dt.make_voxel(rng.random((14, 2)) * [96, 128]), dt.make_voxel(rng.random((14, 2)) * [96, 128]),
    {"maxiter": 5},
)
for corr in (affine, rotation, perspective):
    assert corr(small).img.shape == small.img.shape
relative = dt.RelativeColorCorrection(small, config={"degree": 1})
pts = rng.random((30, 2))
relative.add_calibration_data(pts, rng.random((30, 3)), [0.5, 0.5, 0.5])
relative.calibrate()
relative.setup()
assert torch.isfinite(relative(small.img_as(torch.float32)).img).all()
experimental = dt.ExperimentalColorCorrection(roi=(slice(20, 100), slice(250, 370)))
assert torch.isfinite(experimental(dt.OpticalImage(rig_t, width=2.0, height=1.2)).img).all()
patches = dt.Patches(small.img_as(torch.float32), [2, 3], rel_overlap=0.1)
assert (patches.blend_and_assemble().img - patches.base.img).abs().max() < 1e-6
warped = dt.PiecewisePerspectiveTransform().find_and_warp(patches, rng.random((2, 3, 2)))
assert warped.img.shape == small.img.shape and torch.isfinite(warped.img).all()
deformed = dt.DeformationCorrection(small.img_as(torch.float32), {"N_patches": [2, 2]})
assert deformed(small.img_as(torch.float32)).img.shape == small.img.shape
assert dt.stack([small, small]).series and dt.weight(small, 2.0).img.shape == small.img.shape
with tempfile.TemporaryDirectory() as tmp:
    corrected_base.save(Path(tmp) / "baseline.npz")
    back = dt.imread(Path(tmp) / "baseline.npz", device="cpu")
    assert torch.equal(back.img, corrected_base.img) and type(back) is dt.OpticalImage

# The restoration layer, the solvers and the N-d image core.
noisy = torch.from_numpy(rng.random((40, 48)).astype(np.float32))
field = torch.from_numpy((0.5 + rng.random((40, 48))).astype(np.float32))
for method in ("chambolle", "anisotropic bregman", "isotropic bregman", "heterogeneous bregman"):
    restored = dt.TVD(method=method, weight=0.2, max_num_iter=4)(noisy)
    assert restored.shape == noisy.shape and torch.isfinite(restored).all()
for solver in (dt.Jacobi(maxiter=3), dt.CG(maxiter=3), dt.MG(maxiter=1, depth=2)):
    smooth = dt.split_bregman_tvd(noisy, mu=0.2, omega=field, max_num_iter=2, solver=solver)
    assert torch.isfinite(smooth).all()
    assert torch.isfinite(dt.H1_regularization(noisy, field, 0.5, solver=solver)).all()
assert torch.isfinite(dt.chambolle_tvd(torch.from_numpy(rng.random((8, 10, 12)).astype(np.float32)))).all()
assert dt.laplace(noisy).shape == dt.fv_laplace(noisy, diffusion_coeff=field).shape == noisy.shape
assert dt.backward_diff(noisy, 0)[-1].abs().max() == 0 and dt.forward_diff(noisy, 1)[:, 0].abs().max() == 0
assert dt.median_filter(noisy, 2).shape == noisy.shape and dt.Median()(noisy).shape == noisy.shape
scalar = dt.ScalarImage(noisy, width=0.48, height=0.4)
averaging = dt.VolumeAveraging(dt.REV(0.03, scalar), (field > 0.7).float())
assert torch.isfinite(averaging(scalar).img).all() and dt.uniform_filter(noisy, 4).shape == noisy.shape
assert torch.isfinite(dt.volume_average(scalar, field, 0.03).img).all()
labels = np.zeros((40, 48), int); labels[:, 24:] = 1
assert isinstance(dt.porosity_based_averaging(labels, field, scalar, disk_size=2, rev_size=0.03), dt.VolumeAveraging)
mask = rng.random((40, 48)) > 0.6
for clean in (dt.BinaryRemoveSmallObjects(4), dt.BinaryFillHoles(6), dt.BinaryLocalConvexCover(8)):
    assert clean(mask).shape == mask.shape
assert dt.morphology.skeletonize(mask).dtype == bool and dt.morphology.label(mask)[1] > 0
chain = dt.CombinedModel([dt.Resize(fx=0.5, fy=0.5), dt.TVD(max_num_iter=3), dt.Resize(shape=(40, 48))])
assert chain(scalar).img.shape == (40, 48)
posterior = dt.PriorPosteriorConcentrationAnalysis(
    None, None, None, chain, dt.LinearModel(scaling=2.0), lambda s, prior, diff: s * prior
)
assert posterior(scalar).img.shape == (40, 48)
volume = dt.ScalarImage(torch.from_numpy(rng.random((8, 10, 12)).astype(np.float32)),
                        space_dim=3, dimensions=[0.08, 0.1, 0.12])
cs3 = volume.coordinatesystem
assert cs3.dim == 3 and np.array_equal(cs3.voxel(cs3.coordinate([3, 4, 5]) + 1e-9 * np.array([1, -1, -1])), [3, 4, 5])
assert volume.slice(0.035, "x").shape == (8, 12) and volume.slice(2, 0).shape == (10, 12)
assert dt.reduce_axis(volume, "z").shape == (10, 12) and dt.extrude_along_axis(scalar, 0.1, 3).shape == (3, 40, 48)
assert np.allclose(volume.subregion((slice(1, 5), slice(2, 8), slice(0, 6))).dimensions, [0.04, 0.06, 0.06])
assert volume.eval(dt.make_voxel([[1, 2, 3]])).shape == (1,)
assert abs(volume.integral() - volume.img.double().sum().item() * 1e-6) < 1e-9
assert isinstance(volume.geometry(), dt.Geometry) and volume.geometry().make_extensive(volume).img.shape == (8, 10, 12)
assert abs(dt.PorousGeometry(0.5, **scalar.shape_metadata()).integrate(scalar) - 0.5 * scalar.integral()) < 1e-9
assert scalar.roi(dt.ROI([[0.1, 0.1], [0.4, 0.1], [0.3, 0.3]])).img.shape[0] > 0
assert dt.equalize_voxel_size(scalar).shape == dt.uniform_refinement(scalar, 0).shape == (40, 48)
aligned = dt.CoordinateTransformation(
    scalar.coordinatesystem, scalar.coordinatesystem,
    dt.make_coordinate([[0.1, 0.1], [0.4, 0.1], [0.3, 0.3]]), dt.make_coordinate([[0.11, 0.1], [0.41, 0.1], [0.31, 0.3]]),
)(scalar)
assert aligned.img.shape[1] > 40
with tempfile.TemporaryDirectory() as tmp:
    volume.save(Path(tmp) / "volume")
    back = dt.imread(Path(tmp) / "volume.npz", device="cpu")
    assert back.space_dim == 3 and torch.equal(back.img, volume.img)
    volume.to_csv(Path(tmp) / "volume.csv")
    volume.write(Path(tmp) / "volume.npy")

# Every module of the package imports.
import importlib
import pkgutil

for info in pkgutil.walk_packages(dt.__path__, "darsia_tpu_torch."):
    importlib.import_module(info.name)

# The heterogeneous colour-to-mass chain: per-label colour paths, signal
# functions, flash, expert knowledge, CO2 mass, saved and read back.
labels = np.zeros((40, 48), np.int64); labels[:, 24:] = 1
base = np.full((40, 48, 3), 0.5, np.float32)
probe_c = base.copy(); probe_c[5:20, 4:20] += [0.2, -0.1, 0.0]; probe_c[5:20, 28:44] += [0.1, 0.0, -0.1]
meta = {"width": 0.48, "height": 0.4}
baseline = dt.OpticalImage(torch.from_numpy(base), **meta)
labels_img = dt.Image(torch.from_numpy(labels), scalar=True, **meta)
paths = {k: dt.ColorPath(relative_colors=[np.zeros(3), np.array(v)], base_color=np.full(3, 0.5))
         for k, v in ((0, [0.2, -0.1, 0.0]), (1, [0.1, 0.0, -0.1]))}
interps = {k: dt.ColorPathInterpolation(p, dt.ColorMode.RELATIVE, values=[0, 1]) for k, p in paths.items()}
functions = {k: dt.PWTransformation(supports=[0, 0.5, 1], values=[0, 0.4, 1]) for k in paths}
geometry = dt.ExtrudedPorousGeometry(np.full((40, 48), 0.44), np.full((40, 48), 0.02), **baseline.shape_metadata())
adapter = dt.ExpertKnowledgeAdapter(saturation_g_rois={"gas": np.array([[0.0, 0.4], [0.24, 0.0]])})
c2m = dt.HeterogeneousColorToMassAnalysis(
    baseline, labels_img, dt.ColorMode.RELATIVE, interps, functions, dt.SimpleFlash(0.05, 0.5, 0.5, 1.0),
    dt.CO2MassAnalysis(baseline, 1.01, 23.0), geometry, expert_knowledge_adapter=adapter,
)
result = c2m(dt.OpticalImage(torch.from_numpy(probe_c), **meta))
mass = geometry.integrate(result.mass)
assert mass > 0 and result.saturation_g.img[:, 24:].abs().max() == 0
with tempfile.TemporaryDirectory() as tmp:
    c2m.save(Path(tmp) / "c2m")
    again = dt.HeterogeneousColorToMassAnalysis.from_folder(
        Path(tmp) / "c2m", baseline, labels_img, c2m.co2_mass_analysis, geometry,
        expert_knowledge_adapter=adapter,
    )
    assert geometry.integrate(again(dt.OpticalImage(torch.from_numpy(probe_c), **meta)).mass) == mass
tracker = dt.SimpleRunAnalysis(geometry)
tracker.append(result)
assert tracker.data.mass == [mass]

# Optimal transport: the split-square anchor through wasserstein_distance.
square, squares = np.zeros((10, 10), np.float32), np.zeros((10, 10), np.float32)
square[2:5, 2:5] = 100 / 9
squares[1:3, 1:2], squares[4:7, 7:9] = 12.5, 12.5
w1 = dt.wasserstein_distance(
    *(dt.Image(torch.from_numpy(a), scalar=True, width=1, height=1) for a in (square, squares)),
    method="newton", options={"L": 1e9, "tol_increment": 1e-3, "tol_distance": 1e-3},
)
assert abs(w1 - 0.379543951823) < 0.01, w1
with tempfile.TemporaryDirectory() as tmp:
    dt.ScalarImage(torch.from_numpy(square), width=1, height=1).to_vtk(Path(tmp) / "square")
    lines = (Path(tmp) / "square.vtk").read_text().splitlines()
    # Rows bottom-up: voxel (2, 2) is value 72 of 100.
    assert len(lines) == 10 + 100 and float(lines[10 + 72]) == float(square[2, 2])

# The FluidFlower CO2 analysis from a JSON config and npz frames (per-label
# static CO2 thresholds, per-label Otsu for CO2(g)), and a rig segmented
# and cached.
import json

with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    ff_base = (0.55 + rng.normal(0, 0.005, (30, 50, 3))).astype(np.float32)
    ff_img = ff_base.copy()
    ff_img[8:24, 10:35] += [-0.25, -0.1, 0.2]
    ff_img[12:20, 18:28] += [-0.2, -0.15, 0.25]
    for name, arr in (("base", ff_base), ("img", np.clip(ff_img, 0, 1))):
        dt.OpticalImage(torch.from_numpy(arr), width=2.0, height=1.0).save(tmp / f"{name}.npz")
    common = {"diff option": "absolute", "restoration -> model": True, "restoration resize": 0.5,
              "restoration max_num_iter": 10, "prior remove small objects size": 3,
              "prior fill holes size": 3, "prior resize": 0.5, "prior max_num_iter": 10,
              "posterior criterion": "value", "posterior threshold": 0.02}
    config = {
        "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
        "co2": dict(common, color="negative-key", cleaning_filter=str(tmp / "c1.npy"),
                    **{"prior threshold value": [0.15, 0.12]}),
        "co2(g)": dict(common, color="blue", cleaning_filter=str(tmp / "c2.npy"),
                       **{"prior threshold dynamic": True, "prior threshold value min": 0.1,
                          "prior threshold value max": 0.9}),
    }
    (tmp / "config.json").write_text(json.dumps(config))

    class Layered(dt.FluidFlowerCO2Analysis):
        def __init__(self, *args, **kwargs):
            self.labels = np.repeat([[0], [1]], [15, 15], axis=0).repeat(50, axis=1)
            super().__init__(*args, **kwargs)

    ff = Layered(tmp / "base.npz", tmp / "config.json", tmp / "results", device="cpu")
    co2, gas = ff.single_image_analysis(tmp / "img.npz", write_segmentation_to_file=True)
    assert co2.img[16, 22] and not co2.img[2, 2] and not (gas.img & ~co2.img).any()
    assert (tmp / "c1.npy").exists() and (tmp / "results" / "npy_segmentation" / "img_segmentation.npy").exists()
    rig_arr = np.full((24, 40, 3), 0.3, np.float32)
    rig_arr[12:] = 0.7
    dt.OpticalImage(torch.from_numpy(rig_arr), width=2.0, height=1.0).save(tmp / "rig.npz")
    (tmp / "rig.json").write_text(json.dumps({
        "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
        "segmentation": {"labels_path": str(tmp / "labels.npy"), "marker_points": [[5, 20], [18, 20]]},
    }))
    fluidflower_rig = dt.FluidFlowerRig(tmp / "rig.npz", tmp / "rig.json", device="cpu")
    assert len(np.unique(fluidflower_rig.labels)) == 2 and (tmp / "labels.npy").exists()

# A rig from a TOML config: the depth map, the labels and the rig set up
# (each set-up step warns once that matplotlib is missing and writes its
# .npz), saved, loaded, a photograph read and embedded.
import warnings

from darsia_tpu_torch.presets.workflows import setup as rig_setup

with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    (tmp / "images").mkdir()
    RH, RW = 48, 64
    rig_base = (rng.uniform(0.1, 0.9, (RH, RW, 3)) * 255).astype(np.uint8)
    for i in range(2):
        dt.OpticalImage(torch.from_numpy(np.roll(rig_base, i, axis=1)), width=1.0, height=0.8).save(
            tmp / "images" / f"img_{i:05d}.npz"
        )
    sketch = np.zeros((RH, RW, 3), np.float32)
    sketch[RH // 2 :] = 1.0
    dt.OpticalImage(torch.from_numpy(sketch), width=1.0, height=0.8).save(tmp / "sketch.npz")
    (tmp / "depth.csv").write_text("x,y,mean\n0,0,0.02\n1,0,0.02\n0,0.8,0.03\n1,0.8,0.02\n0.5,0.4,0.025\n")
    (tmp / "imaging.csv").write_text("image_id,datetime\n0,2024-03-01 09:00:00\n1,2024-03-01 10:00:00\n")
    (tmp / "config.toml").write_text(f'''
[data]
folder = "{tmp / 'images'}"
baseline = "img_00000.npz"
results = "{tmp / 'results'}"
[rig]
width = 1.0
height = 0.8
dim = 2
resolution = [{RH}, {RW}]
[depth]
measurements = "{tmp / 'depth.csv'}"
[labeling]
colored_image = "{tmp / 'sketch.npz'}"
[protocols]
imaging = "{tmp / 'imaging.csv'}"
[image_porosity]
mode = "from_image"
tol = 0.0
sample_width = 10
[corrections.curvature.config.bulge]
horizontal_bulge = 1e-6
[color.channel.hue]
color_space = "HSV"
channel = "h"
''')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rig_setup.setup_depth_map(tmp / "config.toml", device="cpu")
        rig_setup.segment_colored_image(tmp / "config.toml", device="cpu")
        rig = rig_setup.setup_rig(dt.Rig, tmp / "config.toml", device="cpu")
    assert sum("matplotlib" in str(w.message) for w in caught) == 1
    results = tmp / "results" / "setup"
    assert (results / "depth_map.npz").exists() and (results / "labels.npz").exists()
    assert not list(results.glob("*.jpg"))
    loaded = dt.Rig.load(results / "rig", device="cpu")
    loaded.load_experiment(rig.experiment)
    photo = tmp / "images" / "img_00001.npz"
    read = loaded.read_image(photo)
    assert torch.equal(read.img, rig.read_image(photo).img) and read.img.device.type == "cpu"
    porosity = loaded.image_porosity.img
    assert porosity.dtype == torch.float32 and 0 <= float(porosity.min()) and float(porosity.max()) <= 1
    config = dt.FluidFlowerConfig(tmp / "config.toml")
    runtime = dt.ColorEmbeddingRuntime(rig=loaded, device="cpu")
    hue = config.color["hue"].to_scalar_image(read, runtime)
    assert hue.img.shape == (RH, RW) and 0.0 < float(hue.img.max()) < 360.0

# The calibration, helper and utils workflows import without OpenCV and
# matplotlib; the colour-path regression runs, and the parts that need OpenCV
# say so.
from darsia_tpu_torch.presets.workflows import (
    calibration, helper, user_interface_calibration, user_interface_helper, user_interface_utils, utils,
)

reg_labels = torch.from_numpy(np.repeat([[0], [1]], [16, 16], axis=0).repeat(24, axis=1))
reg_base = torch.full((32, 24, 3), 0.5)
reg_img = reg_base.clone()
reg_img[4:12, 2:20] += torch.tensor([0.3, -0.1, 0.05])
reg_img[20:28, 2:20] += torch.tensor([-0.1, 0.2, 0.1])
regression = dt.LabelColorPathMapRegression(labels=reg_labels, resolution=21)
spectra = regression.get_color_spectrum([dt.Image(reg_img, width=1.0, height=1.0)], baseline=dt.Image(reg_base, width=1.0, height=1.0))
reg_paths = regression.find_color_path(spectra, num_segments=2)
assert sorted(reg_paths) == [0, 1] and all(np.abs(p.relative_colors[-1]).max() > 0.1 for p in reg_paths.values())
report = helper.color_report(dt.Image(reg_img, width=1.0, height=1.0))
assert set(report) == {"RGB", "HSV", "LAB"}
partial = torch.zeros(8, 8, dtype=torch.bool)
partial[2:5, 2:5] = True
try:
    utils.render_active_region(torch.rand(8, 8, 3), partial)
except ImportError as err:
    assert "OpenCV" in str(err)
else:
    raise AssertionError("contours without OpenCV")
print("ok", tuple(out.img.shape))
"""

# Reads what ``test_port_reads_jax_files_without_the_jax_package`` wrote with
# the JAX package: argv[2] is the folder; per class NAME.npz (the
# correction), NAME_in.npy (an input) and NAME_out.npy (the JAX package's
# result); image.npz with image.npy; affine.npz.
READ_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "darsia_tpu", "cv2", "pandas", "matplotlib", "plotly", "pydicom", "meshio"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
import darsia_tpu_torch as dt

folder = Path(sys.argv[2])
image = dt.imread(folder / "image.npz", device="cpu")
assert type(image) is dt.OpticalImage and type(image.origin) is np.ndarray
assert np.array_equal(image.img.numpy(), np.load(folder / "image.npy"))
assert image.dimensions == [0.96, 1.28] and image.origin.tolist() == [0.25, 1.5]
assert image.name == "baseline" and image.date.year == 2024
volume = dt.imread(folder / "volume.npz", device="cpu")
assert type(volume) is dt.ScalarImage and volume.space_dim == 3 and volume.indexing == "ijk"
assert np.array_equal(volume.img.numpy(), np.load(folder / "volume.npy"))
assert volume.dimensions == [0.08, 0.1, 0.12] and volume.origin.tolist() == [0.5, 0.2, 0.3]
assert volume.slice(0.25, "z").shape == (10, 12)

names = sorted(p.stem[:-3] for p in folder.glob("*_in.npy"))
assert len(names) == 12, names
for name in names:
    correction = dt.read_correction(folder / f"{name}.npz")
    assert type(correction).__name__ == name
    data = torch.from_numpy(np.load(folder / f"{name}_in.npy"))
    if name == "RelativeColorCorrection":
        # No baseline in the file: set it, then set the field up.
        correction.baseline = dt.OpticalImage(data, width=1.28, height=0.96)
        correction.setup()
    got = correction(data).numpy()
    want = np.load(folder / f"{name}_out.npy")
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    elif name == "RotationCorrection":
        # Nearest-voxel picks: equal but for rounding ties of the field.
        assert (got != want).any(axis=-1).mean() <= 1e-3, name
    elif name == "ExperimentalColorCorrection":
        # Held in linear light: the encode's slope is unbounded at black.
        assert np.abs(got**2.2 - want**2.2).max() <= 1e-5, name
    else:
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), name

affine = dt.AffineCorrection(image.coordinatesystem, image.coordinatesystem)
affine.load(folder / "affine.npz")
assert abs(affine.transformation.scaling - 1.01) < 1e-12
try:
    dt.read_correction(folder / "affine.npz")
except ValueError as err:
    assert "coordinate systems" in str(err)
else:
    raise AssertionError("read_correction read an AffineCorrection file")
# The JAX package's colour-to-mass calibration folder, read and applied.
arrays = np.load(folder / "c2m_arrays.npz")
meta = {"width": 2.0, "height": 1.0}
baseline = dt.Image(torch.from_numpy(arrays["base"]), **meta)
labels = dt.Image(torch.from_numpy(arrays["labels"]), scalar=True, **meta)
geometry = dt.ExtrudedPorousGeometry(
    np.full(arrays["labels"].shape, 0.44), np.full(arrays["labels"].shape, 0.02), **baseline.shape_metadata()
)
chain = dt.HeterogeneousColorToMassAnalysis.from_folder(
    folder / "c2m", baseline, labels, dt.CO2MassAnalysis(baseline, 1.01, 22.0), geometry
)
mass = geometry.integrate(chain(dt.Image(torch.from_numpy(arrays["img"]), **meta)).mass)
assert abs(mass - float(arrays["mass"])) <= 1e-6 * abs(float(arrays["mass"])), (mass, arrays["mass"])
# The cleaning filters and labels cache of the JAX package's FluidFlower CO2
# analysis and rig: read, not learnt again, and the same masks.
import json
import os

ff = folder / "ff"
config = json.loads((ff / "config.json").read_text())
caches = [Path(config[k]["cleaning_filter"]) for k in ("co2", "co2(g)")] + [ff / "labels.npy"]
stamps = [os.stat(p).st_mtime_ns for p in caches]
analysis = dt.FluidFlowerCO2Analysis([ff / "base.npz", ff / "base2.npz"], ff / "config.json", ff / "results", device="cpu")
assert np.array_equal(analysis.co2_analysis.threshold_cleaning_filter.numpy(), np.load(caches[0]))
assert np.load(caches[0]).max() > 0
co2, gas = analysis.single_image_analysis(ff / "img.npz")
assert np.array_equal(co2.img.numpy(), np.load(ff / "co2.npy"))
assert np.array_equal(gas.img.numpy(), np.load(ff / "gas.npy"))
rig = dt.FluidFlowerRig(ff / "rig.npz", ff / "rig.json", device="cpu")
assert np.array_equal(rig.labels, np.load(ff / "labels.npy"))
assert [os.stat(p).st_mtime_ns for p in caches] == stamps
loaded = [m for m, module in sys.modules.items() if module is not None]
assert not any(
    m.split(".")[0] in ("jax", "jaxlib", "darsia_tpu", "pandas", "matplotlib", "plotly", "pydicom", "meshio")
    for m in loaded
)
print("ok", len(names))
"""


def test_port_runs_without_jax_and_cv2():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO)],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("ok")


def test_port_reads_jax_files_without_the_jax_package(tmp_path):
    """The JAX package writes an image and one file of every correction class
    that its own ``read_correction`` loads; a subprocess that can import
    neither ``jax`` nor ``darsia_tpu`` reads and applies them all."""
    import datetime

    import jax.numpy as jnp
    import numpy as np
    from test_torch_color_corrections import _checker_frame, _jax_written, jax_find

    import darsia_tpu as da

    frame, _ = _checker_frame()
    objects = _jax_written(tmp_path, frame, jax_find(frame)[1])
    rng = np.random.default_rng(0)
    small = (frame[:96, :128] / 255.0).astype(np.float32)
    meta = {"width": 1.28, "height": 0.96}
    relative = da.RelativeColorCorrection(da.OpticalImage(jnp.asarray(small), **meta), config={"degree": 1})
    relative.add_calibration_data(rng.random((30, 2)), rng.random((30, 3)), [0.5, 0.5, 0.5])
    relative.calibrate()
    relative.setup()
    roi = (slice(100, 220), slice(1300, 1480))
    objects["RelativeColorCorrection"] = (relative, small)
    objects["ExperimentalColorCorrection"] = (da.ExperimentalColorCorrection(roi=roi), frame)
    objects["RotationCorrection"] = (da.RotationCorrection([48, 64], rotations=[0.01]), small)
    for name, (obj, data) in objects.items():
        obj.save(tmp_path / name)
        np.save(tmp_path / f"{name}_in.npy", data)
        np.save(tmp_path / f"{name}_out.npy", np.asarray(obj(jnp.asarray(data))))
    image = da.OpticalImage(
        jnp.asarray(frame[:96, :128]),
        origin=[0.25, 1.5],
        name="baseline",
        date=datetime.datetime(2024, 3, 1),
        **meta,
    )
    image.save(tmp_path / "image")
    np.save(tmp_path / "image.npy", frame[:96, :128])
    volume = rng.random((8, 10, 12)).astype(np.float32)
    da.ScalarImage(
        jnp.asarray(volume), space_dim=3, dimensions=[0.08, 0.1, 0.12], origin=[0.5, 0.2, 0.3]
    ).save(tmp_path / "volume")
    np.save(tmp_path / "volume.npy", volume)
    cs = image.coordinatesystem
    src = np.asarray(cs.coordinate(rng.random((5, 2)) * [96, 128]))
    da.AffineCorrection(cs, cs, da.make_coordinate(src), da.make_coordinate(1.01 * src)).save(
        tmp_path / "affine"
    )
    # A colour-to-mass calibration folder, written as the JAX package
    # writes it (its CSV through pandas), with the scene and its mass.
    from test_torch_color_to_mass import _arrays, _perturbed

    chain, img, geom = _perturbed(da)
    chain.save(tmp_path / "c2m")
    scene = _arrays()
    np.savez(tmp_path / "c2m_arrays.npz", mass=geom.integrate(chain(img).mass), **scene)
    # A FluidFlower CO2 analysis with two baselines (its cleaning filters)
    # and a rig (its labels cache), written by the JAX package.
    import json

    from test_torch_fluidflower import scene

    ff = tmp_path / "ff"
    ff.mkdir()
    config = json.loads(scene(ff, layered=False)["jax"].read_text())
    (ff / "config.json").write_text(json.dumps(config))
    noisy = np.clip(0.55 + np.random.default_rng(3).normal(0, 0.02, (60, 100, 3)), 0, 1)
    da.Image(noisy.astype(np.float32), width=2.0, height=1.0).save(ff / "base2.npz")
    analysis = da.FluidFlowerCO2Analysis([ff / "base.npz", ff / "base2.npz"], ff / "config.json", ff / "results")
    co2, gas = analysis.single_image_analysis(ff / "img.npz")
    np.save(ff / "co2.npy", np.asarray(co2.img))
    np.save(ff / "gas.npy", np.asarray(gas.img))
    rig_arr = np.full((40, 60, 3), 0.3, np.float32)
    rig_arr[20:] = 0.7
    da.Image(rig_arr, width=2.0, height=1.0).save(ff / "rig.npz")
    (ff / "rig.json").write_text(json.dumps({
        "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
        "segmentation": {"labels_path": str(ff / "labels.npy"), "marker_points": [[10, 30], [30, 30]]},
    }))
    da.FluidFlowerRig(ff / "rig.npz", ff / "rig.json")
    assert (ff / "labels.npy").exists()
    # The image file does pickle a class of the JAX package.
    import zipfile

    with zipfile.ZipFile(tmp_path / "image.npz") as archive:
        assert b"darsia_tpu" in archive.read("metadata.npy")

    proc = subprocess.run(
        [sys.executable, "-c", READ_SCRIPT, str(REPO), str(tmp_path)],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 12"


def test_package_sources_import_no_jax():
    banned = ("jax", "darsia_tpu", "cv2", "pandas", "matplotlib", "plotly", "pydicom", "meshio")
    for path in (REPO / "darsia_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in banned, f"{path}: {line}"
