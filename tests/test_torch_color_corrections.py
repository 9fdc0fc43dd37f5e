"""The port's color-side rig corrections against the JAX package: balances,
Cheung-2004 polynomials, k-means, color checkers and their finder, color
correction, the characteristic-data extraction, the interpolation onto
images, illumination corrections (fitted, patchwise, dynamic), and
``read_correction`` of files the JAX package wrote.

Scenes: a seeded noise frame with a 4x6 checker of the post-2014 reference
swatches painted into its upper-right quadrant (the frame of chip_smoke.py
at half size), a smooth frame lit by a point source for the illumination
fits, and the small scenes of ``tests/unit/test_corrections_color.py``.  The
same numpy inputs go through both packages on the CPU.
"""

import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.corrections import read_correction as jax_read_correction
from darsia_tpu.corrections.color.colorcheckerfinder import find_colorchecker as jax_find
from darsia_tpu.corrections.color.colorcorrection import ClassicColorChecker as JaxClassic
from darsia_tpu.ops import polynomial_color as jax_poly
from darsia_tpu.presets.workflows.config.corrections import IlluminationCorrectionConfig
from darsia_tpu.utils import interpolation as jax_interp
from darsia_tpu.utils.extractcharacteristicdata import extract_characteristic_data as jax_extract
from darsia_tpu.utils.kmeans import dominant_color as jax_dominant
from darsia_tpu.utils.kmeans import kmeans as jax_kmeans
from darsia_tpu_torch.corrections.color.colorcorrection import ClassicColorChecker
from darsia_tpu_torch.ops import polynomial_color as poly
from darsia_tpu_torch.utils import interpolation
from darsia_tpu_torch.utils.extractcharacteristicdata import extract_characteristic_data
from darsia_tpu_torch.utils.kmeans import dominant_color, kmeans

torch.set_num_threads(1)

#: Balance matrices: the same float64 numpy solves on the same swatches.
MATRIX_TOL = 1e-10
#: A balance applied in float32 (matmul rounding).
APPLIED_TOL = 1e-6
#: Colors through float32 pipelines of both packages (swatch extraction,
#: color correction, polynomial terms, patchwise and dynamic illumination).
COLOR_TOL = 1e-5
#: Swatch colors (k-means on float32 crops of both packages).
SWATCH_TOL = 1e-6
#: Illumination scaling fields, relative to their largest value: the JAX
#: thin-plate spline is float32, the port's float64.
SCALING_REL_TOL = 1e-4

# The checker frame (chip_smoke.py's, at half size): a 4x6 checker of
# 30 px swatches painted at (100, 1300) on seeded noise.
FRAME = (894, 1590)
CHECKER_AT, SWATCH_PX = (100, 1300), 30


def _checker_frame(seed=0) -> tuple[np.ndarray, np.ndarray]:
    ref = da.ColorCheckerAfter2014().swatches_rgb
    frame = (np.random.default_rng(seed).random(FRAME + (3,)) * 255).astype(np.uint8)
    r0, c0 = CHECKER_AT
    patch = np.kron(ref, np.ones((SWATCH_PX, SWATCH_PX, 1))) * 255
    frame[r0 : r0 + 4 * SWATCH_PX, c0 : c0 + 6 * SWATCH_PX] = patch.astype(np.uint8)
    h, w = 4 * SWATCH_PX, 6 * SWATCH_PX
    corners = np.array([[r0, c0], [r0 + h, c0], [r0 + h, c0 + w], [r0, c0 + w]])
    return frame, corners


@pytest.fixture(scope="module")
def checker_frame():
    frame, corners = _checker_frame()
    j_checker, j_voxels = jax_find(frame)
    return {"frame": frame, "corners": corners, "voxels": j_voxels, "checker": j_checker}


def _lit_frame(H=96, W=128, seed=3) -> np.ndarray:
    """A smooth frame lit by a point source (uint8 RGB)."""
    yy, xx = np.mgrid[:H, :W]
    light = 1.0 / (1 + ((yy - 20) ** 2 + (xx - 90) ** 2) / 8000.0)
    rng = np.random.default_rng(seed)
    frame = 0.6 * light[..., None] * (0.8 + 0.2 * rng.random((H, W, 3)))
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


# ------------------------------------------------------------- balances


def _swatch_pairs(seed=1):
    rng = np.random.default_rng(seed)
    src = rng.random((18, 3))
    B = np.array([[0.9, 0.05, 0.0], [0.1, 1.1, 0.0], [0.0, 0.02, 0.97]])
    return src, src @ B + np.array([0.01, -0.02, 0.005]) + 0.01 * rng.random((18, 3))


@pytest.mark.parametrize("name", ["WhiteBalance", "ColorBalance", "AffineBalance"])
def test_balances_against_jax(name):
    src, dst = _swatch_pairs()
    j, t = getattr(da, name)(), getattr(dt, name)()
    j.find_balance(src, dst)
    t.find_balance(src, dst)
    assert np.abs(t.balance_scaling - j.balance_scaling).max() <= MATRIX_TOL
    if name == "AffineBalance":
        assert np.abs(t.balance_translation - j.balance_translation).max() <= MATRIX_TOL
    img = np.random.default_rng(2).random((20, 30, 3)).astype(np.float32)
    j_out = np.asarray(j.apply_balance(jnp.asarray(img)))
    t_out = t.apply_balance(torch.from_numpy(img))
    assert isinstance(t_out, torch.Tensor) and t_out.dtype == torch.float32
    assert np.abs(t_out.numpy() - j_out).max() <= APPLIED_TOL
    assert np.abs(t.apply_balance(img) - j_out).max() <= APPLIED_TOL  # numpy in, numpy out


@pytest.mark.parametrize("modes", [("diagonal", "affine"), ("diagonal", "linear"), ("linear",)])
def test_adaptive_balance_against_jax(modes):
    src, dst = _swatch_pairs(3)
    j, t = da.AdaptiveBalance(), dt.AdaptiveBalance()
    for mode in modes:
        j.find_balance(src, dst, mode=mode)
        t.find_balance(src, dst, mode=mode)
    assert np.abs(t.balance_scaling - j.balance_scaling).max() <= MATRIX_TOL
    assert np.abs(t.balance_translation - j.balance_translation).max() <= MATRIX_TOL
    img = np.random.default_rng(4).random((10, 12, 3)).astype(np.float32)
    assert np.abs(t.apply_balance(torch.from_numpy(img)).numpy() - np.asarray(j.apply_balance(img))).max() <= APPLIED_TOL
    img_out = dt.corrections.color_balance(torch.from_numpy(img), src, dst).numpy()
    assert np.abs(img_out - np.asarray(da.color_balance(img, src, dst))).max() <= APPLIED_TOL


@pytest.mark.parametrize("terms", [3, 5, 7, 8, 10, 11])
def test_cheung2004_against_jax(terms):
    rng = np.random.default_rng(terms)
    src = rng.random((24, 3))
    dst = np.clip(src @ np.array([[1.1, 0.0, 0.1], [0.0, 0.9, 0.0], [0.05, 0.0, 1.0]]) + 0.02, 0, 1)
    j_terms = np.asarray(jax_poly.cheung2004_terms(jnp.asarray(src, jnp.float32), terms))
    t_terms = poly.cheung2004_terms(torch.from_numpy(src.astype(np.float32)), terms).numpy()
    assert np.array_equal(t_terms, j_terms)
    M = poly.fit_cheung2004(src, dst, terms)
    assert np.abs(M - jax_poly.fit_cheung2004(src, dst, terms)).max() <= COLOR_TOL
    img = rng.random((16, 20, 3)).astype(np.float32)
    j_out = np.asarray(jax_poly.colour_correction(jnp.asarray(img), src, dst, terms))
    t_out = poly.colour_correction(torch.from_numpy(img), src, dst, terms).numpy()
    assert np.abs(t_out - j_out).max() <= COLOR_TOL
    with pytest.raises(ValueError):
        poly.cheung2004_terms(torch.zeros(2, 3), 4)


# ---------------------------------------------------------------- k-means


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_kmeans_against_jax(seed):
    rng = np.random.default_rng(seed)
    data = np.concatenate([rng.normal(c, 0.05, (200, 3)) for c in (0.2, 0.5, 0.8)])
    for k in (1, 3, 5):
        j_labels, j_centers = jax_kmeans(data, k, seed=seed)
        t_labels, t_centers = kmeans(data, k, seed=seed)
        assert np.array_equal(t_labels, j_labels) and np.array_equal(t_centers, j_centers)
    assert np.array_equal(dominant_color(data), jax_dominant(data))
    # Fewer distinct points than clusters: the seeding's early exit.
    flat = np.ones((10, 3))
    assert np.array_equal(kmeans(flat, 4)[1], jax_kmeans(flat, 4)[1])


@pytest.mark.parametrize("mode", ["most_common", "least_common", "all"])
def test_extract_characteristic_data_against_jax(mode):
    rng = np.random.default_rng(5)
    signal = rng.random((40, 50, 3)).astype(np.float32)
    mask = rng.random((40, 50)) > 0.3
    samples = [(slice(2, 12), slice(3, 13)), (slice(20, 35), slice(30, 48))]
    kw = {"samples": samples, "mask": mask, "mode": mode, "filter": lambda x: 0 * x}
    j_out = jax_extract(signal, **kw)
    t_out = extract_characteristic_data(torch.from_numpy(signal), **kw)
    if mode == "all":
        for a, b in zip(t_out, j_out):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    else:
        # The filter is accepted and not applied, as in the JAX package.
        assert np.array_equal(t_out, j_out) and np.abs(t_out).max() > 0
    scalar = signal[..., 0]
    assert np.array_equal(extract_characteristic_data(torch.from_numpy(scalar)), jax_extract(scalar))


# -------------------------------------------------------- color checkers


def test_reference_checkers_against_jax():
    assert np.abs(dt.ColorCheckerAfter2014().swatches_rgb - da.ColorCheckerAfter2014().swatches_rgb).max() <= SWATCH_TOL
    assert np.abs(ClassicColorChecker().swatches_rgb - JaxClassic().swatches_rgb).max() <= SWATCH_TOL
    assert dt.ColorCheckerAfter2014().swatches_rgb.dtype == np.float32
    assert np.array_equal(dt.ColorCheckerAfter2014().swatches_RGB, da.ColorCheckerAfter2014().swatches_RGB)


@pytest.mark.parametrize("noise", [0.0, 0.02])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_custom_checker_extraction_against_jax(dtype, noise):
    ref = da.ColorCheckerAfter2014().swatches_rgb
    rng = np.random.default_rng(6)
    img = np.kron(ref, np.ones((23, 27, 1))) + noise * rng.random((92, 162, 3))
    img = (img * 255).astype(np.uint8) if dtype == "uint8" else img.astype(np.float32)
    j = da.CustomColorChecker(image=img).swatches_rgb
    t = dt.CustomColorChecker(image=torch.from_numpy(img)).swatches_rgb
    # The two resizes round differently in the last bit (1.8e-7); on a noisy
    # swatch a k-means boundary can then move a pixel between clusters,
    # which moves the dominant color by up to ~1/2500 of the noise spread.
    tol = SWATCH_TOL if noise == 0.0 else 1e-4
    assert t.shape == (4, 6, 3) and np.abs(t - j).max() <= tol


def test_custom_checker_reads_only_the_resized_crop(monkeypatch):
    """The crop is warped to the checker's aspect ratio and resized on its
    device; the host reads one tensor, the 500 px wide crop."""
    ref = da.ColorCheckerAfter2014().swatches_rgb
    crop = torch.from_numpy(np.kron(ref, np.ones((60, 60, 1))).astype(np.float32))
    reads, numpy = [], torch.Tensor.numpy

    def record(self, *args, **kwargs):
        reads.append(tuple(self.shape))
        return numpy(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "numpy", record)
    swatches = dt.CustomColorChecker(image=crop).swatches_rgb
    monkeypatch.undo()
    assert len(reads) == 1 and reads[0][1:] == (500, 3)
    assert np.abs(swatches - da.CustomColorChecker(image=crop.numpy()).swatches_rgb).max() <= SWATCH_TOL


def test_find_colorchecker_against_jax(checker_frame):
    frame, corners = checker_frame["frame"], checker_frame["corners"]
    checker, voxels = dt.find_colorchecker(torch.from_numpy(frame))
    assert np.array_equal(voxels, checker_frame["voxels"])
    assert np.array_equal(checker.swatches_rgb, checker_frame["checker"].swatches_rgb)
    # The painted corners, within the finder's search grid.
    assert np.abs(voxels - corners).max() <= 16
    # From an Image as well, and refusing a corner without a checker.
    assert np.array_equal(dt.find_colorchecker(dt.OpticalImage(frame, device="cpu"))[1], voxels)
    with pytest.raises(ValueError):
        dt.find_colorchecker(torch.from_numpy(frame), strategy="lower_left")


def _rotate_roi(voxels: np.ndarray, start: int) -> np.ndarray:
    """The same box, listed from another corner (the brown swatch there)."""
    return np.roll(voxels, -start, axis=0)


@pytest.mark.parametrize("roi_kind", ["box", "rotated box", "quadrilateral"])
@pytest.mark.parametrize("whitebalancing", [True, False])
@pytest.mark.parametrize("balancing", ["darsia", "colour"])
def test_color_correction_against_jax(checker_frame, roi_kind, whitebalancing, balancing):
    frame, voxels = checker_frame["frame"], np.asarray(checker_frame["voxels"])
    if roi_kind == "rotated box":
        roi = _rotate_roi(voxels, 2)
    elif roi_kind == "quadrilateral":
        roi = voxels + np.array([[3, 0], [0, 2], [-2, 0], [0, -3]])
    else:
        roi = voxels
    config = {"roi": roi, "balancing": balancing, "whitebalancing": whitebalancing, "clip": False}
    if balancing == "colour":
        config["colorbalancing"] = "linear"
    base_j = da.OpticalImage(frame)
    base_t = dt.OpticalImage(frame, device="cpu")
    j = da.ColorCorrection(base_j, dict(config))
    t = dt.ColorCorrection(base_t, dict(config))
    assert np.abs(t.colorchecker.swatches_rgb - j.colorchecker.swatches_rgb).max() <= SWATCH_TOL
    probe = np.clip(frame.astype(np.float32) * 0.9 + 10, 0, 255).astype(np.uint8)
    j_out = np.asarray(j.correct_array(probe))
    t_out = t.correct_array(torch.from_numpy(probe))
    assert t_out.dtype == torch.float32 and t_out.shape == probe.shape
    assert np.abs(t_out.numpy() - j_out).max() <= COLOR_TOL


def test_color_correction_reference_checker_clip_and_inactive(checker_frame):
    frame, voxels = checker_frame["frame"], checker_frame["voxels"]
    j = da.ColorCorrection(config={"roi": voxels, "clip": True})
    t = dt.ColorCorrection(config={"roi": voxels, "clip": True})
    out = t.correct_array(torch.from_numpy(frame)).numpy()
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert np.abs(out - np.asarray(j.correct_array(frame))).max() <= COLOR_TOL
    inactive = dt.ColorCorrection()
    assert torch.equal(inactive.correct_array(torch.from_numpy(frame)), torch.from_numpy(frame) / 255.0)
    with pytest.raises(ValueError, match="ROI"):
        dt.ColorCorrection(config={"clip": True})


# ----------------------------------------------------- interpolation


def _image_pair(H=40, W=56, **meta):
    meta = {"width": 1.4, "height": 1.0, **meta}
    return (
        da.ScalarImage(np.zeros((H, W), np.float32), **meta),
        dt.ScalarImage(np.zeros((H, W), np.float32), device="cpu", **meta),
    )


def _measurements(n=14, seed=8):
    rng = np.random.default_rng(seed)
    x, y = rng.random(n) * 1.4, rng.random(n)
    return x, y, 1.0 + 0.3 * np.sin(2 * x) * np.cos(3 * y)


@pytest.mark.parametrize("method", ["rbf", "illumination", "linear", "quadratic", "cubic", "quartic"])
def test_interpolate_to_image_against_jax(method):
    j_img, t_img = _image_pair()
    data = _measurements()
    j_out = np.asarray(jax_interp.interpolate_to_image(data, j_img, method=method).img)
    t_out = interpolation.interpolate_to_image(data, t_img, method=method)
    assert isinstance(t_out, dt.ScalarImage) and t_out.img.dtype == torch.float32
    assert t_out.img.shape == j_out.shape
    # The JAX spline is float32 at these scales, the port's float64.
    assert np.abs(t_out.img.numpy() - j_out).max() <= SCALING_REL_TOL * np.abs(j_out).max()
    assert torch.equal(t_img.img, torch.zeros_like(t_img.img))  # a copy was filled


def test_interpolate_measurements_2d_against_jax():
    j_img, t_img = _image_pair()
    data = _measurements()
    j_out = np.asarray(jax_interp.interpolate_measurements_2d(data, j_img.coordinatesystem))
    t_out = interpolation.interpolate_measurements_2d(data, t_img.coordinatesystem, "cpu")
    assert t_out.dtype == torch.float32 and t_out.shape == j_out.shape
    assert np.abs(t_out.numpy() - j_out).max() <= SCALING_REL_TOL * np.abs(j_out).max()
    # Without a device the spline is evaluated on the card (JAX's two
    # arguments); with no card that raises instead of falling back.
    if torch.cuda.is_available():
        assert interpolation.interpolate_measurements_2d(data, t_img.coordinatesystem).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            interpolation.interpolate_measurements_2d(data, t_img.coordinatesystem)


def test_interpolation_helpers_against_jax(tmp_path):
    coords = np.random.default_rng(9).random((7, 2))
    for degree in range(5):
        assert np.array_equal(
            interpolation.polynomial_design_matrix(coords, degree),
            jax_interp.polynomial_design_matrix(coords, degree),
        )
    j_img, t_img = _image_pair()
    data = _measurements(5)
    # Five points cap the quartic fit at degree 1 in both packages.
    assert np.allclose(
        interpolation.polynomial_interpolation(data, t_img.coordinatesystem, 4),
        jax_interp.polynomial_interpolation(data, j_img.coordinatesystem, 4),
        rtol=0, atol=1e-12,
    )
    csv = tmp_path / "m.csv"
    x, y, v = _measurements()
    csv.write_text("X,y,value\n" + "".join(f"{a},{b},{c}\n" for a, b, c in zip(x, y, v)))
    t_out = interpolation.interpolate_to_image_from_csv(csv, "value", t_img, method="quadratic")
    j_out = jax_interp.interpolate_to_image((x, y, v), j_img, method="quadratic")
    assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= 1e-6


# ---------------------------------------------------- illumination


@pytest.mark.parametrize("colorspace", ["hsl-scalar", "rgb", "lab-scalar", "gray"])
@pytest.mark.parametrize("method", ["rbf", "quartic", "illumination"])
def test_illumination_correction_against_jax(method, colorspace):
    frame = _lit_frame()
    H, W = frame.shape[:2]
    config = IlluminationCorrectionConfig(width=10, num_samples=20, seed=42)
    j, t = da.IlluminationCorrection(), dt.IlluminationCorrection()
    mask = np.ones((H, W), bool)
    mask[:, :8] = False
    samples = t.select_random_samples(torch.from_numpy(mask), config)
    # np.unique drops repeated draws: 19 distinct patches here.
    assert samples == j.select_random_samples(mask, config) and len(samples) >= 18
    groups = [samples[:10], samples[10:]]
    meta = {"width": 1.2, "height": 0.9}
    kw = {"outliers": 0.1, "interpolation": method, "colorspace": colorspace, "mask": mask}
    j.setup(da.OpticalImage(frame, **meta), groups, **kw)
    t.setup(dt.OpticalImage(frame, device="cpu", **meta), groups, **kw)
    assert len(t.local_scaling) == len(j.local_scaling)
    for js, ts in zip(j.local_scaling, t.local_scaling):
        a, b = np.asarray(js.img), ts.img.numpy()
        assert b.shape == (H, W)
        assert np.abs(b - a).max() <= SCALING_REL_TOL * np.abs(a).max()
    probe = np.roll(frame, 2, axis=1)
    j_out = np.asarray(j.correct_array(jnp.asarray(probe)))
    t_out = t.correct_array(torch.from_numpy(probe)).numpy()
    assert t_out.dtype == np.float32
    assert np.abs(t_out - j_out).max() <= SCALING_REL_TOL * np.abs(j_out).max()


def test_illumination_sampling_edge_cases():
    t = dt.IlluminationCorrection()
    config = IlluminationCorrectionConfig(width=5, num_samples=5, seed=42)
    assert t.select_random_samples(np.zeros((50, 50), bool), config) == []
    img = torch.rand(8, 9, 3)
    assert t.correct_array(img) is img  # not set up: unchanged
    with pytest.raises(NotImplementedError):
        t.correct_array(torch.rand(8, 9, 1))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_patchwise_illumination_against_jax(dtype, tmp_path):
    rng = np.random.default_rng(7)
    base = (_lit_frame(60, 80).astype(np.float32) / 255 * 0.5 + 0.25).astype(np.float32)
    shifted = np.roll(base, 3, axis=0)
    kw = {"nw": 8, "limit": 12}
    j = da.PatchwiseIlluminationCorrection(image=base, baseline_images=[base, shifted], **kw)
    t = dt.PatchwiseIlluminationCorrection(
        image=torch.from_numpy(base), baseline_images=[torch.from_numpy(base), torch.from_numpy(shifted)], **kw
    )
    assert t.correction_grid.shape == j.correction_grid.shape
    assert np.abs(t.correction_grid - j.correction_grid).max() <= COLOR_TOL
    probe = base * (0.9 + 0.1 * rng.random(base.shape)).astype(np.float32)
    if dtype == "uint8":
        probe = (probe * 255).astype(np.uint8)
    j_out = np.asarray(j.correct_array(probe))
    t_out = t.correct_array(torch.from_numpy(probe)).numpy()
    assert t_out.dtype == probe.dtype
    if dtype == "uint8":
        # Rounding at a half may flip one level.
        diff = np.abs(t_out.astype(int) - j_out.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        assert np.abs(t_out - j_out).max() <= COLOR_TOL
    means = t.extract_color_values_patches(torch.from_numpy(base), full=True)
    j_means = j.extract_color_values_patches(base, full=True)
    assert all(np.abs(a - b).max() <= COLOR_TOL for a, b in zip(means, j_means))
    # A path goes through imread (on the card; tests/test_torch_io.py),
    # which decodes a photograph with OpenCV and refuses a broken one.
    (tmp_path / "baseline.jpg").write_bytes(b"\0")
    jpg = tmp_path / "baseline.jpg"
    with pytest.raises(ValueError, match="Could not read"):
        dt.PatchwiseIlluminationCorrection(image=jpg, baseline_images=[jpg])
    with pytest.raises(FileNotFoundError):
        dt.PatchwiseIlluminationCorrection(image="none.npz", baseline_images=["none.npz"])


def test_dynamic_illumination_against_jax():
    base = _lit_frame(40, 40, seed=5)
    samples = [(slice(5, 15), slice(5, 15)), (slice(20, 30), slice(20, 30))]
    j, t = da.DynamicIlluminationCorrection(), dt.DynamicIlluminationCorrection()
    j.setup(base, samples)
    t.setup(torch.from_numpy(base), samples)
    assert np.abs(t.base_colors - j.base_colors).max() <= COLOR_TOL
    for probe in ((base * 0.7).astype(np.uint8), base.astype(np.float32) / 300.0):
        j_out = np.asarray(j.correct_array(probe))
        t_out = t.correct_array(torch.from_numpy(probe)).numpy()
        assert np.abs(t_out - j_out).max() <= COLOR_TOL * max(1.0, np.abs(j_out).max())


def test_dynamic_illumination_reads_only_the_patches(monkeypatch):
    """The frame's sample patches are copied to the host, never the frame."""
    from darsia_tpu_torch.corrections.color import dynamicilluminationcorrection as dyn

    base = torch.from_numpy(_lit_frame(40, 40, seed=5))
    samples = [(slice(5, 15), slice(5, 15)), (slice(20, 30), slice(20, 30))]
    t = dt.DynamicIlluminationCorrection()
    t.setup(base, samples)
    read = []
    as_numpy = dyn.as_numpy
    monkeypatch.setattr(dyn, "as_numpy", lambda x: read.append(tuple(x.shape)) or as_numpy(x))
    t.correct_array(base)
    assert read == [(10, 10, 3), (10, 10, 3)]


# ------------------------------------------------ read_correction


def _jax_written(tmp_path, frame_u8, voxels):
    """One file per class, each written by the JAX package, with the JAX
    object and an input to correct."""
    small = frame_u8[:96, :128]
    lit = _lit_frame()
    cfg_curv = {
        "crop": {"pts_src": [[2, 3], [93, 2], [94, 124], [3, 126]], "width": 1.4, "height": 1.0},
        "bulge": {"horizontal_bulge": 1e-6, "vertical_bulge": 2e-6},
    }
    illum = da.IlluminationCorrection()
    config = IlluminationCorrectionConfig(width=10, num_samples=12, seed=42)
    illum.setup(
        da.OpticalImage(lit),
        [illum.select_random_samples(np.ones(lit.shape[:2], bool), config)],
        interpolation="quartic",
    )
    dyn = da.DynamicIlluminationCorrection()
    dyn.setup(lit, [(slice(5, 15), slice(5, 15)), (slice(40, 60), slice(50, 70))])
    objects = {
        "TypeCorrection": (da.TypeCorrection(np.float32), small),
        "TranslationCorrection": (da.TranslationCorrection([1.5, -2.0]), small),
        "DriftCorrection": (
            da.DriftCorrection(small, {"roi": np.array([[10, 10], [80, 10], [80, 110], [10, 110]])}),
            np.roll(small, (1, 2), axis=(0, 1)),
        ),
        "CurvatureCorrection": (da.CurvatureCorrection(config=cfg_curv), small),
        "ColorCorrection": (
            da.ColorCorrection(da.OpticalImage(frame_u8), {"roi": voxels, "clip": False}),
            frame_u8,
        ),
        "IlluminationCorrection": (illum, lit),
        "PatchwiseIlluminationCorrection": (
            da.PatchwiseIlluminationCorrection(image=lit, baseline_images=[lit], nw=8, limit=12),
            lit,
        ),
        "DynamicIlluminationCorrection": (dyn, (lit * 0.8).astype(np.uint8)),
        "Resize": (da.Resize(shape=(48, 64), interpolation="inter_linear"), small),
    }
    for name, (obj, _) in objects.items():
        obj.save(tmp_path / name)
    return objects


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory, checker_frame):
    path = tmp_path_factory.mktemp("jax_corrections")
    objects = _jax_written(path, checker_frame["frame"], checker_frame["voxels"])
    return path, objects


@pytest.mark.parametrize(
    "name",
    [
        "TypeCorrection",
        "TranslationCorrection",
        "DriftCorrection",
        "CurvatureCorrection",
        "ColorCorrection",
        "IlluminationCorrection",
        "PatchwiseIlluminationCorrection",
        "DynamicIlluminationCorrection",
        "Resize",
    ],
)
def test_read_correction_of_jax_files(jax_files, name):
    path, objects = jax_files
    file = path / f"{name}.npz"
    # No JAX or JAX-package type reaches the file: every member loads as
    # plain numpy and Python objects.
    with zipfile.ZipFile(file) as archive:
        for member in archive.namelist():
            raw = archive.read(member)
            assert b"jax" not in raw and b"darsia_tpu" not in raw, (name, member)
    j_obj, data = objects[name]
    t_obj = dt.read_correction(file)
    assert type(t_obj).__name__ == name
    assert type(t_obj).__module__.startswith("darsia_tpu_torch.")
    j_out = np.asarray(j_obj(jnp.asarray(data)))
    t_out = t_obj(torch.from_numpy(data)).numpy()
    assert t_out.shape == j_out.shape and t_out.dtype == j_out.dtype
    if t_out.dtype == np.uint8:
        diff = np.abs(t_out.astype(int) - j_out.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        assert np.abs(t_out - j_out).max() <= COLOR_TOL * max(1.0, np.abs(j_out).max())


@pytest.mark.parametrize("name", ["TypeCorrection", "DriftCorrection", "ColorCorrection", "IlluminationCorrection", "Resize"])
def test_port_files_read_back_by_both_packages(jax_files, tmp_path, name):
    path, objects = jax_files
    t_obj = dt.read_correction(path / f"{name}.npz")
    t_obj.save(tmp_path / name)
    again = dt.read_correction(tmp_path / f"{name}.npz")
    j_again = jax_read_correction(tmp_path / f"{name}.npz")
    data = objects[name][1]
    out = again(torch.from_numpy(data)).numpy()
    assert np.array_equal(out, t_obj(torch.from_numpy(data)).numpy())
    j_out = np.asarray(j_again(jnp.asarray(data)))
    assert np.abs(out.astype(np.float64) - j_out).max() <= 1.0 + COLOR_TOL


def test_type_correction_and_unknown_class(tmp_path):
    t = dt.TypeCorrection(torch.float32)
    assert t.data_type == np.dtype(np.float32)
    img = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert torch.equal(t.correct_array(img), img / 255.0)
    np.savez(tmp_path / "x.npz", class_name="NoSuchCorrection")
    with pytest.raises(ValueError, match="Unknown"):
        dt.read_correction(tmp_path / "x.npz")
