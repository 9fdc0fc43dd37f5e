"""The port's relative and experimental colour corrections, and the
approximation spaces under them, against the JAX package.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Tolerances: the host's float64 fits and evaluations <= 1e-10; the
field evaluated on the device (one float64 product cast to float32) within
float32 rounding of the host path; colour products of float32 frames <= 1e-5.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 96, 128
META = {"width": 1.28, "height": 0.96}
#: Host fits and evaluations (float64 on both sides).
HOST_TOL = 1e-10
#: Per-pixel colour products of float32 frames with values of order 1.
COLOR_TOL = 1e-5


def _smooth_frame(seed=0):
    """A frame of a few smooth colour fields in [0.2, 0.8]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    chans = [
        0.5 + 0.3 * np.sin(2 * np.pi * (rng.random() * xx + rng.random() * yy) + k)
        for k in range(3)
    ]
    return np.stack(chans, axis=-1).astype(np.float32)


def _gain(cs):
    """A smooth per-pixel colour gain 1 / q, with q in the span of the
    degree-2 space (1, y, y^2, x, x y, x y^2): the correction diag(q) is in
    the ansatz, so the fit can take a frame back to its reference exactly."""
    coords = np.asarray(cs.coordinates).reshape((H, W, 2), order="F")
    x, y = coords[..., 0], coords[..., 1]
    q = np.stack([1.0 + 0.2 * x - 0.1 * y, 0.9 + 0.1 * x * y, 1.1 - 0.15 * y * y + 0.05 * x], axis=-1)
    return (1.0 / q).astype(np.float32)


def _images(frame):
    return da.OpticalImage(jnp.asarray(frame), **META), dt.OpticalImage(frame, device="cpu", **META)


def _sample_boxes(rng, n, size=8):
    rows = rng.integers(0, H - size, n)
    cols = rng.integers(0, W - size, n)
    return [(slice(int(r), int(r) + size), slice(int(c), int(c) + size)) for r, c in zip(rows, cols)]


# ----------------------------------------------------------- approximations


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_polynomial_space_and_linear_approximation_against_jax(degree):
    rng = np.random.default_rng(degree)
    pts = rng.random((40, 2))
    t_space, j_space = dt.PolynomialApproximationSpace(degree), da.PolynomialApproximationSpace(degree)
    assert t_space.size == j_space.size
    for t_b, j_b in zip(t_space(pts), j_space(pts)):
        assert np.abs(t_b - j_b).max() <= HOST_TOL
    t, j = dt.LinearApproximation(t_space, (3, 3)), da.LinearApproximation(j_space, (3, 3))
    values = rng.random((40, 3, 3))
    t.fit(pts, values)
    j.fit(pts, values)
    assert t.shape == j.shape and t.size == j.size
    assert np.abs(t.coefficients - j.coefficients).max() <= HOST_TOL
    assert np.abs(t.evaluate(pts) - j.evaluate(pts)).max() <= HOST_TOL
    # Over a coordinate system: the host path, and the device product.
    jimg, timg = _images(_smooth_frame())
    host = t.evaluate(timg.coordinatesystem)
    assert host.shape == (H, W, 3, 3)
    assert np.abs(host - j.evaluate(jimg.coordinatesystem)).max() <= HOST_TOL
    on_device = t.evaluate_on(timg.coordinatesystem, "cpu")
    assert on_device.dtype == torch.float32 and on_device.shape == (H, W, 3, 3)
    # Within float32 rounding of the float64 host path.
    scale = np.abs(host).max()
    assert np.abs(on_device.numpy() - host).max() <= 2 * np.finfo(np.float32).eps * scale


def test_voxel_domain_and_scalar_values_against_jax():
    jimg, timg = _images(_smooth_frame())
    rng = np.random.default_rng(0)
    t = dt.LinearApproximation(dt.PolynomialApproximationSpace(1), 2, domain="voxels")
    j = da.LinearApproximation(da.PolynomialApproximationSpace(1), 2, domain="voxels")
    t.coefficients = j.coefficients = rng.random(t.shape)
    host = t.evaluate(timg.coordinatesystem)
    assert np.abs(host - j.evaluate(jimg.coordinatesystem)).max() <= HOST_TOL
    on_device = t.evaluate_on(timg.coordinatesystem, "cpu").numpy()
    assert np.abs(on_device - host).max() <= 2 * np.finfo(np.float32).eps * np.abs(host).max()


def test_radial_space_against_jax():
    rng = np.random.default_rng(4)
    pts = rng.random((30, 2))
    center = np.array([0.4, 0.6])
    t_space = dt.RadialPolynomialApproximationSpace(3, center)
    j_space = da.RadialPolynomialApproximationSpace(3, center)
    assert t_space.size == j_space.size == 4
    for k in range(4):
        assert np.abs(t_space.basis(pts, k) - j_space.basis(pts, k)).max() <= HOST_TOL
        on_tensor = t_space.basis(torch.from_numpy(pts), k).numpy()
        assert np.abs(on_tensor - j_space.basis(pts, k)).max() <= 1e-14
    t_space.set_center(np.zeros(2))
    assert np.abs(t_space.basis(pts, 1) - np.linalg.norm(pts, axis=-1)).max() <= HOST_TOL


# ------------------------------------------------------------------ relative


def _calibrated_pair(degree=2, seed=1):
    """Both packages' corrections, calibrated from samples of a reference
    frame multiplied by a smooth gain."""
    reference = _smooth_frame(seed)
    jref, tref = _images(reference)
    frame = reference * _gain(tref.coordinatesystem)
    jimg, timg = _images(frame)
    rng = np.random.default_rng(seed)
    voxels = np.stack([rng.integers(0, H, 60), rng.integers(0, W, 60)], axis=1)
    coords = np.asarray(tref.coordinatesystem.coordinate(voxels))
    t = dt.RelativeColorCorrection(timg, config={"degree": degree})
    j = da.RelativeColorCorrection(jimg, config={"degree": degree})
    # Three groups of similar colours: per reference colour, the observed
    # colours it takes under the gain at the sample positions.
    gain = _gain(tref.coordinatesystem)[voxels[:, 0], voxels[:, 1]]
    for color in ([0.7, 0.3, 0.4], [0.2, 0.6, 0.5], [0.5, 0.5, 0.8], [0.4, 0.7, 0.2]):
        observed = np.asarray(color) * gain
        t.add_calibration_data(coords, observed, color)
        j.add_calibration_data(coords, observed, color)
    t.calibrate()
    j.calibrate()
    return t, j, frame, reference


@pytest.mark.parametrize("degree", [1, 2])
def test_relative_color_correction_against_jax(degree):
    t, j, frame, reference = _calibrated_pair(degree)
    assert np.abs(t.correction.coefficients - j.correction.coefficients).max() <= 1e-8
    with pytest.raises(ValueError, match="setup"):
        t.correct_array(torch.from_numpy(frame))
    t.setup()
    j.setup()
    assert t._evaluated.shape == (H, W, 3, 3) and t._evaluated.dtype == torch.float32
    assert np.abs(t._evaluated.numpy() - np.asarray(j._evaluated)).max() <= COLOR_TOL
    t_out = t.correct_array(torch.from_numpy(frame))
    j_out = np.asarray(j.correct_array(jnp.asarray(frame)))
    assert t_out.dtype == torch.float32 and t_out.shape == frame.shape
    assert np.abs(t_out.numpy() - j_out).max() <= COLOR_TOL
    if degree == 2:
        # The inverse gain lies in the ansatz: the frame returns to its
        # reference colours, to the conditioning of the 54-column fit.
        assert np.abs(t_out.numpy() - reference).max() <= 1e-4
    # Through an Image, at construction.
    chained = dt.OpticalImage(frame, transformations=[t], device="cpu", **META)
    assert torch.equal(chained.img, t_out)


def test_relative_color_sampling_front_ends_against_jax():
    frame = _smooth_frame(3)
    jimg, timg = _images(frame)
    other = np.roll(frame, (5, 9), axis=(0, 1))
    jother, tother = _images(other)
    rng = np.random.default_rng(3)
    samples = [_sample_boxes(rng, 5), _sample_boxes(rng, 4)]
    t = dt.RelativeColorCorrection(timg, [timg, tother], {"degree": 1})
    j = da.RelativeColorCorrection(jimg, [jimg, jother], {"degree": 1})
    t.define_similar_colors(samples_per_image=samples)
    j.define_similar_colors(samples_per_image=samples)
    t.define_reference_color(samples=samples[0])
    j.define_reference_color(samples=samples[0])
    j.reference_data.append(j.reference_data[0])  # one reference per group
    t.reference_data.append(t.reference_data[0])
    assert len(t.data) == len(j.data) == 2
    for (t_c, t_v), (j_c, j_v) in zip(t.data, j.data):
        assert np.abs(t_c - j_c).max() <= HOST_TOL
        # k-means on the same float32 patches, copied patch by patch.
        assert np.abs(t_v - j_v).max() <= 1e-6
    assert np.abs(t.reference_data[0] - j.reference_data[0]).max() <= 1e-6
    t.calibrate()
    j.calibrate()
    assert np.abs(t.correction.coefficients - j.correction.coefficients).max() <= 1e-4

    # The tensorial variant: a single image given directly.
    t2 = dt.RelativeColorCorrection(timg, timg, {"degree": 1})
    j2 = da.RelativeColorCorrection(jimg, jimg, {"degree": 1})
    ref_samples, loc_samples = _sample_boxes(rng, 3), _sample_boxes(rng, 6)
    t2.define_similar_and_reference_colors_tensorial(ref_samples, loc_samples)
    j2.define_similar_and_reference_colors_tensorial(ref_samples, loc_samples)
    assert len(t2.data) == len(j2.data) == 3
    for (t_c, t_v), (j_c, j_v) in zip(t2.data, j2.data):
        assert np.abs(t_c - j_c).max() <= HOST_TOL
        assert np.array_equal(t_v, j_v)
    for t_r, j_r in zip(t2.reference_data, j2.reference_data):
        assert np.abs(t_r - j_r).max() <= 1e-6


def test_relative_color_without_samples_names_the_assistants(monkeypatch):
    """Without samples the boxes are picked by hand with the
    BoxSelectionAssistant: headless it raises naming it, and where matplotlib
    does not import the error names matplotlib."""
    _, timg = _images(_smooth_frame())
    t = dt.RelativeColorCorrection(timg, timg)
    calls = (
        t.define_similar_colors,
        t.define_reference_color,
        t.define_similar_and_reference_colors_tensorial,
    )
    import matplotlib

    matplotlib.use("Agg")
    for call in calls:
        with pytest.raises(RuntimeError, match="BoxSelectionAssistant requires an interactive"):
            call()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    with pytest.raises(ValueError):
        t.calibrate()
    with pytest.raises(ValueError):
        dt.RelativeColorCorrection(timg, config={"method": "spline"})


def test_relative_color_files_and_read_back_as_in_jax(tmp_path):
    """Files go both ways.  Mirrors
    darsia_tpu/corrections/color/relativecolorcorrection.py:197-208 and
    :226-232: a correction read back by ``read_correction`` has no baseline,
    so it corrects only after ``baseline`` is set and ``setup()`` has run."""
    t, j, frame, _ = _calibrated_pair()
    t.setup()
    j.setup()
    t.save(tmp_path / "torch")
    j.save(tmp_path / "jax")
    t_read = dt.read_correction(tmp_path / "jax.npz")
    j_read = da.read_correction(tmp_path / "torch.npz")
    assert isinstance(t_read, dt.RelativeColorCorrection) and t_read.config == {"degree": 2}
    assert np.abs(t_read.correction.coefficients - j.correction.coefficients).max() <= HOST_TOL
    assert np.abs(j_read.correction.coefficients - t.correction.coefficients).max() <= HOST_TOL
    with pytest.raises(AssertionError):
        j_read.correct_array(jnp.asarray(frame))
    with pytest.raises(ValueError, match="setup"):
        t_read.correct_array(torch.from_numpy(frame))
    with pytest.raises(ValueError, match="Baseline"):
        t_read.setup()
    t_read.baseline = t.baseline
    t_read.setup()
    j_read.baseline = j.baseline
    j_read.setup()
    t_out = t_read.correct_array(torch.from_numpy(frame)).numpy()
    assert np.abs(t_out - np.asarray(j.correct_array(jnp.asarray(frame)))).max() <= COLOR_TOL
    assert np.abs(np.asarray(j_read.correct_array(jnp.asarray(frame))) - t_out).max() <= COLOR_TOL
    # With a baseline at hand, load() sets the field up itself.
    t_with = dt.RelativeColorCorrection(t.baseline)
    t_with.load(tmp_path / "jax.npz")
    assert np.array_equal(t_with.correct_array(torch.from_numpy(frame)).numpy(), t_out)


# -------------------------------------------------------------- experimental


CHECKER_ROI = (slice(8, 88), slice(4, 124))


def _checker_frame(seed=5):
    """A noise frame with the post-2014 checker painted into CHECKER_ROI
    (20 px per swatch)."""
    rng = np.random.default_rng(seed)
    frame = rng.random((H, W, 3)).astype(np.float32)
    ref = da.ColorCheckerAfter2014().swatches_rgb
    # A mild colour cast on the painted checker, to be corrected.
    cast = np.kron(ref, np.ones((20, 20, 1))) * np.array([0.9, 1.0, 0.8])
    frame[CHECKER_ROI] = cast.astype(np.float32)
    return frame


def test_eotf_against_jax():
    frame = _checker_frame() * 1.2 - 0.1  # beyond [0, 1] on both sides
    t, j = dt.EOTF(), da.EOTF()
    assert t.gamma == j.gamma
    decoded = t.adjust(torch.from_numpy(frame))
    assert np.abs(decoded.numpy() - np.asarray(j.adjust(jnp.asarray(frame)))).max() <= 1e-6
    encoded = t.inverse_approx(decoded)
    assert np.abs(encoded.numpy() - np.asarray(j.inverse_approx(jnp.asarray(decoded.numpy())))).max() <= 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("with_roi", [True, False])
def test_experimental_color_correction_against_jax(dtype, with_roi):
    frame = _checker_frame()
    if not with_roi:
        frame = np.ascontiguousarray(frame[CHECKER_ROI])
    if dtype == np.uint8:
        frame = (frame * 255).astype(np.uint8)
    roi = CHECKER_ROI if with_roi else None
    t, j = dt.ExperimentalColorCorrection(roi=roi), da.ExperimentalColorCorrection(roi=roi)
    t_out = t.correct_array(torch.from_numpy(frame))
    j_out = np.asarray(j.correct_array(jnp.asarray(frame)))
    assert t_out.dtype == torch.float32 and t_out.shape == frame.shape
    # The swatch k-means sees a crop resized by another library (equal to
    # the last bit on clean swatches), then a float32 matmul and two powers.
    # The encode's slope is unbounded at 0 ((1e-9) ** (1 / 2.2) = 8e-5), so
    # the colour tolerance holds in linear light and away from black.
    diff = np.abs(t_out.numpy() - j_out)
    assert diff[j_out > 0.05].max() <= COLOR_TOL
    assert np.abs(t_out.numpy() ** 2.2 - j_out**2.2).max() <= COLOR_TOL
    assert diff.max() <= 1e-3
    # The cast is corrected: the checker returns to the reference colours.
    ref = np.kron(da.ColorCheckerAfter2014().swatches_rgb, np.ones((20, 20, 1)))
    checker = t_out.numpy()[CHECKER_ROI] if with_roi else t_out.numpy()
    assert np.abs(checker - ref)[5:-5, 5:-5].mean() <= 0.02


def test_experimental_color_correction_files_against_jax(tmp_path):
    frame = _checker_frame()
    for k, roi in enumerate((CHECKER_ROI, None)):
        t, j = dt.ExperimentalColorCorrection(roi=roi), da.ExperimentalColorCorrection(roi=roi)
        t.save(tmp_path / f"torch{k}")
        j.save(tmp_path / f"jax{k}")
        t_read = dt.read_correction(tmp_path / f"jax{k}.npz")
        j_read = da.read_correction(tmp_path / f"torch{k}.npz")
        assert isinstance(t_read, dt.ExperimentalColorCorrection)
        assert t_read.roi == roi and j_read.roi == roi
    t_read = dt.read_correction(tmp_path / "jax0.npz")
    assert torch.equal(
        t_read.correct_array(torch.from_numpy(frame)),
        dt.ExperimentalColorCorrection(roi=CHECKER_ROI).correct_array(torch.from_numpy(frame)),
    )


# ----------------------------------------------------- no full-frame reads


def _record_host_reads(monkeypatch):
    """Every device -> host read of a tensor, by shape (on the CPU the
    methods that would copy from a card)."""
    reads = []
    for name in ("numpy", "cpu", "tolist", "item"):
        original = getattr(torch.Tensor, name)

        def record(self, *args, _original=original, **kwargs):
            reads.append(tuple(self.shape))
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, record)
    return reads


def test_relative_color_correct_array_reads_nothing_to_the_host(monkeypatch):
    t, _, frame, _ = _calibrated_pair()
    t.setup()
    img = torch.from_numpy(frame)
    reads = _record_host_reads(monkeypatch)
    out = t.correct_array(img)
    monkeypatch.undo()
    assert reads == []
    assert out.shape == frame.shape


def test_experimental_color_correct_array_reads_only_the_crop(monkeypatch):
    """The frame is decoded and corrected where it lies; the host sees the
    resized checker crop (500 px wide) and the 4x6 reference swatches."""
    img = torch.from_numpy(_checker_frame())
    t = dt.ExperimentalColorCorrection(roi=CHECKER_ROI)
    reads = _record_host_reads(monkeypatch)
    out = t.correct_array(img)
    monkeypatch.undo()
    assert out.shape == img.shape
    assert reads, "the swatch extraction reads its crop"
    full = H * W * 3
    assert all(int(np.prod(shape)) < full or shape[1:] == (500, 3) for shape in reads)
    assert (H, W, 3) not in reads
