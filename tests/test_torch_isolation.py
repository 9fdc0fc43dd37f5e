"""The port imports and runs with JAX and OpenCV absent.

A subprocess blocks ``jax`` and ``cv2`` (``sys.modules[name] = None`` makes
any import of them fail), imports ``darsia_tpu_torch`` and runs the small
correct -> register -> concentrate pipeline on a numpy-made frame.
"""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "cv2", "pandas", "matplotlib"):
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
print("ok", tuple(out.img.shape))
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


def test_package_sources_import_no_jax():
    banned = ("jax", "darsia_tpu", "cv2", "pandas", "matplotlib")
    for path in (REPO / "darsia_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in banned, f"{path}: {line}"
