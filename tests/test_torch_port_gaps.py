"""The port's last gaps against the JAX package, closed.

The same seeded numpy inputs go through ``darsia_tpu`` and
``darsia_tpu_torch`` (the port on CPU tensors):

* ``Image.img`` assignment: the JAX package's own idioms (a numpy array
  assigned to an image's ``img``) leave a tensor on the image's device, and
  ``copy``, a nearest resize, arithmetic and ``Geometry.integrate`` then give
  the JAX package's results bitwise (the integral within 1e-6); an object
  array is kept as it is.
* ``TranslationAnalysis.build_fused_aligner``: bitwise ``fused_align``'s
  result; against the JAX package's aligner within the tolerances and
  edge-pixel rule of ``tests/test_torch_registration.py``.
* ``extract_quadrilateral_ROI`` with ``width``/``height``, ``shape``,
  ``pts_dst``, both ``indexing`` values and both interpolations: bilinear
  within 1e-5 of data in [0, 1]; nearest equal but at samples within
  rounding of a cell edge (counted and bounded); the same rule at the
  domain's edge for both.
* ``masked_normalized_cross_correlation`` within 1e-6.
* The plots on matplotlib's Agg backend: the quiver's X/Y/U/V and the
  ``imshow`` arrays within 1e-6 of the JAX figures'; ``ConcentrationAnalysis``
  gives bitwise the same concentration at ``verbosity`` 0 and 2.
"""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
from unittest import mock  # noqa: E402

import matplotlib.pyplot as plt  # noqa: E402

import darsia_tpu as da  # noqa: E402
import darsia_tpu_torch as dt  # noqa: E402
from darsia_tpu.corrections.shape.quad import extract_quadrilateral_ROI as jax_quad_roi  # noqa: E402
from darsia_tpu.ops.fft import masked_normalized_cross_correlation as jax_ncc  # noqa: E402
from darsia_tpu.restoration.averaging import uniform_filter  # noqa: E402
from darsia_tpu_torch.corrections.shape.quad import quad_coordinate_grid  # noqa: E402
from darsia_tpu_torch.ops.fft import masked_normalized_cross_correlation  # noqa: E402
from darsia_tpu_torch.utils.point import make_voxel  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (12, 16)
META = {"width": 1.6, "height": 1.2}


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- Image.img
#
# Each case: the image class, the array the image is made from, and the
# array a JAX idiom assigns to ``img`` afterwards.


def _idioms() -> dict:
    rng = _rng(7)
    scalar = rng.random(SHAPE).astype(np.float32)
    colour = rng.random(SHAPE + (3,)).astype(np.float32)
    base = rng.random(SHAPE + (3,)).astype(np.float32)
    mask = rng.random(SHAPE) > 0.3
    return {
        # presets/workflows/rig.py:437, the boolean porosity.
        "rig_boolean_porosity": ("ScalarImage", scalar, scalar > 0.5),
        # presets/analysis/porosity.py:141, a clipped porosity.
        "porosity_clip": ("ScalarImage", scalar, np.clip(scalar * 1.4 - 0.2, 0, 1)),
        # presets/workflows/heterogeneous_color_analysis.py:93, image - base.
        "relative_colour": ("OpticalImage", colour, colour - base),
        # presets/workflows/analysis/expert_knowledge.py:92, a masked image.
        "expert_knowledge": ("ScalarImage", scalar, np.where(mask, scalar, 0.0)),
        # examples/wasserstein.py:28, a normalised distribution.
        "wasserstein_normalise": ("ScalarImage", scalar, scalar / np.float32(3.7)),
        # examples/regularization.py:15, added noise.
        "regularization_noise": (
            "ScalarImage",
            scalar,
            scalar + np.float32(0.1) * rng.standard_normal(SHAPE, dtype=np.float32),
        ),
    }


@pytest.mark.parametrize("case", list(_idioms()))
def test_assigned_numpy_becomes_a_tensor_and_agrees_with_jax(case):
    cls, made, assigned = _idioms()[case]
    j = getattr(da, cls)(made, **META)
    t = getattr(dt, cls)(made, device="cpu", **META)
    j.img = assigned
    t.img = assigned
    assert isinstance(t.img, torch.Tensor) and t.img.device == CPU
    assert np.array_equal(t.img.numpy(), np.asarray(j.img))

    assert np.array_equal(t.copy().img.numpy(), np.asarray(j.copy().img))
    kw = {"shape": (6, 8), "interpolation": "inter_nearest"}
    assert np.array_equal(dt.resize(t, **kw).img.numpy(), np.asarray(da.resize(j, **kw).img))
    if assigned.dtype != bool:
        assert np.array_equal((t + t).img.numpy(), np.asarray((j + j).img))
        assert np.array_equal((t * 0.5).img.numpy(), np.asarray((j * 0.5).img))
    if cls == "ScalarImage":
        got = dt.Geometry(**t.shape_metadata()).integrate(t)
        want = da.Geometry(**j.shape_metadata()).integrate(j)
        assert abs(float(got) - float(want)) <= 1e-6


def test_assigned_tensor_is_kept_and_object_arrays_stay_as_they_are():
    t = dt.ScalarImage(np.zeros(SHAPE, np.float32), device="cpu", **META)
    tensor = torch.ones(SHAPE, dtype=torch.float64)
    t.img = tensor
    assert t.img is tensor
    t.img = 2.5
    assert isinstance(t.img, torch.Tensor) and t.img.device == CPU and float(t.img) == 2.5
    t.img = [[1.0, 2.0], [3.0, 4.0]]
    assert isinstance(t.img, torch.Tensor) and t.img.shape == (2, 2)
    names = np.array([["a", "b"], ["c", "d"]], dtype=object)
    j = da.Image(np.zeros((2, 2), np.float32))
    t = dt.Image(np.zeros((2, 2), np.float32), device="cpu")
    j.img = names
    t.img = names
    assert t.img is names and j.img is names
    held = dt.Image(names)
    assert held.img is names and held.shape == da.Image(names).shape


def test_a_tensor_given_with_a_device_moves_there_at_construction():
    source = torch.zeros(SHAPE)
    kept = dt.ScalarImage(source, **META)
    assert kept.img is source
    moved = dt.ScalarImage(source, device="meta", **META)
    assert moved.img.device == torch.device("meta") and moved.shape == SHAPE
    moved.img = np.ones(SHAPE, np.float32)
    assert moved.img.device == torch.device("meta")


def test_metadata_deepcopy_and_save_round_trip_after_assignment(tmp_path):
    import copy

    t = dt.ScalarImage(np.zeros(SHAPE, np.float32), device="cpu", **META)
    t.img = _rng(3).random(SHAPE).astype(np.float32)
    assert "_img" not in t.metadata() and "img" not in t.metadata()
    clone = copy.deepcopy(t)
    assert isinstance(clone.img, torch.Tensor) and torch.equal(clone.img, t.img)
    clone.img = np.zeros(SHAPE, np.float32)
    assert not torch.equal(clone.img, t.img)
    t.save(tmp_path / "image")
    back = dt.imread(tmp_path / "image.npz", device="cpu")
    assert torch.equal(back.img, t.img) and back.dimensions == t.dimensions
    j = da.imread(tmp_path / "image.npz")
    assert np.array_equal(np.asarray(j.img), t.img.numpy())


# ------------------------------------------------------- fused aligner

REG_SHAPE = (96, 128)


def _textured(seed):
    rng = _rng(seed)
    smooth = np.asarray(uniform_filter(jnp.asarray(rng.random(REG_SHAPE).astype(np.float32)), 7))
    return (smooth - smooth.min()) / (smooth.max() - smooth.min())


@pytest.fixture(scope="module")
def aligners():
    base = _textured(5)
    probe = np.roll(base, shift=(3, -4), axis=(0, 1))
    kw = {"N_patches": [3, 4], "rel_overlap": 0.3, "quality_tol": 0.01}
    j = da.TranslationAnalysis(da.ScalarImage(base, width=1.0, height=1.0), **kw)
    t = dt.TranslationAnalysis(dt.ScalarImage(torch.from_numpy(base), width=1.0, height=1.0), **kw)
    return base, probe, j, t


def test_build_fused_aligner_is_fused_align(aligners):
    _, probe, _, t = aligners
    out, shifts, quality = t.build_fused_aligner()(torch.from_numpy(probe))
    assert out.dtype == torch.float32 and out.shape == REG_SHAPE
    assert shifts.shape == (12, 2) and quality.shape == (12,)
    aligned = t.fused_align(dt.ScalarImage(torch.from_numpy(probe), width=1.0, height=1.0))
    assert torch.equal(aligned.img, out)
    # A colour frame at another bound.
    colour = torch.from_numpy(np.stack([probe, probe**2, 1 - probe], axis=-1))
    out_c, _, _ = t.build_fused_aligner(max_disp=60)(colour)
    aligned_c = t.fused_align(dt.OpticalImage(colour, width=1.0, height=1.0), max_disp=60)
    assert out_c.shape == REG_SHAPE + (3,) and torch.equal(aligned_c.img, out_c)


def test_build_fused_aligner_against_jax(aligners):
    base, probe, j, t = aligners
    out_j, shifts_j, quality_j = (np.asarray(a) for a in j.build_fused_aligner()(jnp.asarray(probe)))
    out_t, shifts_t, quality_t = (a.numpy() for a in t.build_fused_aligner()(torch.from_numpy(probe)))
    # Patch shifts of the two FFT libraries agree to 1e-3 px
    # (tests/test_torch_pipeline.py); qualities are correlation peaks.
    assert np.abs(shifts_t - shifts_j).max() <= 1e-3
    assert np.abs(quality_t - quality_j).max() <= 1e-3
    # A field difference dx moves a bilinear sample by at most dx times the
    # image's largest one-pixel step; a sample within rounding of the domain
    # edge lands on either side of the mode="constant" mask
    # (tests/test_torch_registration.py).  The fields: the JAX package's
    # float32 spline against the port's float64 one, plus the shifts' spread.
    step = max(np.abs(np.diff(probe, axis=0)).max(), np.abs(np.diff(probe, axis=1)).max())
    off = np.abs(out_t - out_j) > 2 * (1e-3 + 2e-3) * step + 1e-6
    assert off.sum() <= 4
    assert all(out_t[p] == 0 or out_j[p] == 0 for p in zip(*np.nonzero(off)))
    interior = (slice(24, -24), slice(32, -32))
    assert np.abs(out_t[interior] - base[interior]).mean() < 0.05


# ------------------------------------------------------ quadrilateral ROI

QUAD_SRC = (40, 56)
PTS_RC = np.array([[3.2, 4.1], [36.7, 2.5], [38.1, 52.9], [1.4, 50.3]])
PTS_DST_RC = np.array([[1.0, 2.0], [20.0, 0.5], [22.5, 30.0], [0.5, 28.0]])


def _quad_cases() -> dict:
    xy = PTS_RC[:, ::-1].copy()
    return {
        "aspect": (PTS_RC, "matrix", {"width": 2.0, "height": 1.0}),
        "aspect_xy": (xy, "reverse matrix", {"width": 1.0, "height": 1.3}),
        "voxels": (make_voxel(PTS_RC), "reverse matrix", {"width": 2.0, "height": 1.0}),
        "shape": (PTS_RC, "matrix", {"shape": (50, 70)}),
        "shape_pts_dst": (PTS_RC, "matrix", {"shape": (24, 31), "pts_dst": PTS_DST_RC}),
        "shape_pts_dst_xy": (xy, "reverse matrix", {"shape": (24, 31), "pts_dst": PTS_DST_RC[:, ::-1].copy()}),
        "own_corners": (None, "reverse matrix", {"width": 1.0, "height": 1.0}),
        "own_corners_shape": (None, "reverse matrix", {}),
    }


def _jax_points(points):
    """The JAX package's VoxelArray for the port's."""
    return da.make_voxel(np.asarray(points)) if isinstance(points, dt.VoxelArray) else points


@pytest.mark.parametrize("interpolation", ["inter_linear", "inter_nearest"])
@pytest.mark.parametrize("case", list(_quad_cases()))
def test_extract_quadrilateral_roi_against_jax(case, interpolation):
    pts, indexing, kwargs = _quad_cases()[case]
    data = _rng(11).random(QUAD_SRC + (3,)).astype(np.float32)
    out_t = dt.extract_quadrilateral_ROI(
        torch.from_numpy(data), pts_src=pts, indexing=indexing, interpolation=interpolation, **kwargs
    ).numpy()
    out_j = np.asarray(
        jax_quad_roi(jnp.asarray(data), _jax_points(pts), indexing=indexing, interpolation=interpolation, **kwargs)
    )
    assert out_t.shape == out_j.shape and out_t.dtype == np.float32
    if "shape" in kwargs:
        assert out_t.shape[:2] == kwargs["shape"]

    # The samples' positions, from the port's field.
    if pts is None:
        H, W = QUAD_SRC
        pts_rc = np.array([[0, 0], [H, 0], [H, W], [0, W]], dtype=float)
    else:
        pts_rc = np.asarray(pts, dtype=float)
        if indexing == "reverse matrix" and not isinstance(pts, dt.VoxelArray):
            pts_rc = pts_rc[:, ::-1]
    dst = kwargs.get("pts_dst")
    dst_rc = None if dst is None else (dst if indexing == "matrix" else np.asarray(dst)[:, ::-1])
    coords = quad_coordinate_grid(pts_rc, out_t.shape[:2], dst_rc, device=CPU).numpy()
    upper = np.array(QUAD_SRC, dtype=float).reshape(2, 1, 1) - 1
    if interpolation == "inter_nearest":
        # Within rounding of a cell edge (x.5; the domain's edges -0.5 and
        # upper + 0.5 among them) the two packages may pick either cell.
        near = (np.abs(np.abs(coords - np.floor(coords)) - 0.5) < 1e-3).any(axis=0)
        off = (out_t != out_j).any(axis=-1)
        assert not (off & ~near).any() and off.sum() <= max(4, near.sum() // 2)
    else:
        near = ((np.abs(coords) < 1e-3) | (np.abs(coords - upper) < 1e-3)).any(axis=0)
        off = (np.abs(out_t - out_j) > 1e-5).any(axis=-1)
        assert not (off & ~near).any() and off.sum() <= max(4, near.sum() // 2)
        assert all(out_t[p].max() == 0 or out_j[p].max() == 0 for p in zip(*np.nonzero(off)))


def test_extract_quadrilateral_roi_keeps_integer_types_and_corners():
    data = (_rng(12).random(QUAD_SRC) * 255).astype(np.uint8)
    for interpolation in ("inter_linear", "inter_nearest"):
        out = dt.extract_quadrilateral_ROI(
            torch.from_numpy(data), pts_src=PTS_RC, indexing="matrix", interpolation=interpolation, shape=(20, 25)
        )
        assert out.dtype == torch.uint8
    # The destination corners sample the source corners.
    grid = quad_coordinate_grid(PTS_RC, (24, 31), PTS_DST_RC, device=CPU).numpy()
    for (r, c), want in zip(PTS_DST_RC, PTS_RC):
        if r == int(r) and c == int(c):
            assert np.abs(grid[:, int(r), int(c)] - want).max() <= 1e-3


# ---------------------------------------------------------------- NCC


@pytest.mark.parametrize("shape,dtype", [((17, 23), np.float32), ((8, 9, 3), np.float64), ((30,), np.uint8)])
def test_masked_normalized_cross_correlation_against_jax(shape, dtype):
    rng = _rng(sum(shape))
    src = (rng.random(shape) * (255 if dtype == np.uint8 else 1)).astype(dtype)
    dst = (0.7 * src + 0.3 * rng.random(shape) * (255 if dtype == np.uint8 else 1)).astype(dtype)
    got = masked_normalized_cross_correlation(torch.from_numpy(src), torch.from_numpy(dst))
    want = float(jax_ncc(jnp.asarray(src), jnp.asarray(dst)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6
    assert "masked_normalized_cross_correlation" in dt.ops.fft.__all__


# --------------------------------------------------------------- plots


def _plain(x):
    if isinstance(x, np.ma.MaskedArray):
        return np.asarray(x.filled(np.nan), dtype=float)
    return np.asarray(x, dtype=float)


def _figures(fn):
    """The figures ``fn`` draws (show patched out): per figure, its label
    and per axis its title, images' arrays and quivers' X/Y/U/V."""
    before = set(plt.get_fignums())
    with mock.patch.object(plt, "show", lambda *a, **k: None):
        fn()
    out = []
    for num in sorted(set(plt.get_fignums()) - before):
        fig = plt.figure(num)
        axes = []
        for ax in fig.axes:
            quivers = [c for c in ax.collections if type(c).__name__ == "Quiver"]
            axes.append(
                {
                    "title": ax.get_title(),
                    "images": [_plain(im.get_array()) for im in ax.images],
                    "quivers": [{k: _plain(getattr(q, k)) for k in ("X", "Y", "U", "V")} for q in quivers],
                }
            )
        out.append((fig.get_label(), axes))
    plt.close("all")
    return out


def _assert_figures_agree(got, want, tol=1e-6):
    assert want and len(got) == len(want)
    for (label_t, axes_t), (label_j, axes_j) in zip(got, want):
        assert label_t == label_j and len(axes_t) == len(axes_j)
        for a_t, a_j in zip(axes_t, axes_j):
            assert a_t["title"] == a_j["title"]
            assert len(a_t["images"]) == len(a_j["images"]) and len(a_t["quivers"]) == len(a_j["quivers"])
            for i_t, i_j in zip(a_t["images"], a_j["images"]):
                assert i_t.shape == i_j.shape and np.allclose(i_t, i_j, rtol=0, atol=tol, equal_nan=True)
            for q_t, q_j in zip(a_t["quivers"], a_j["quivers"]):
                for key in "XYUV":
                    assert q_t[key].shape == q_j[key].shape
                    assert np.abs(q_t[key] - q_j[key]).max() <= tol, key


@pytest.fixture(scope="module")
def registrations():
    base = _textured(2)
    probe = np.roll(base, shift=(2, -4), axis=(0, 1))
    kw = {"N_patches": [3, 3], "rel_overlap": 0.3, "quality_tol": 0.01}
    out = {"base": base, "probe": probe}
    for num_levels in (1, 2):
        j = da.ImageRegistration(da.ScalarImage(base, width=1.0, height=1.0), num_levels=num_levels, **kw)
        t = dt.ImageRegistration(
            dt.ScalarImage(torch.from_numpy(base), width=1.0, height=1.0), num_levels=num_levels, **kw
        )
        j(da.ScalarImage(probe, width=1.0, height=1.0))
        t(dt.ScalarImage(torch.from_numpy(probe), width=1.0, height=1.0))
        out[num_levels] = (j, t)
    return out


#: The quiver's displacements: the two packages' interpolants agree within
#: the field tolerance of tests/test_torch_registration.py (JAX's float32
#: spline error plus the two FFT libraries' 1e-3 px spread, twice).
QUIVER_TOL = 1e-2


@pytest.mark.parametrize("num_levels", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_registration_plot_matches_jax(registrations, num_levels, masked):
    j, t = registrations[num_levels]
    mask_np = _rng(4).random(REG_SHAPE) > 0.4
    kw_j = {"scaling": 2.0, "mask": da.ScalarImage(mask_np, width=1.0, height=1.0) if masked else None}
    kw_t = {"scaling": 2.0, "mask": dt.ScalarImage(torch.from_numpy(mask_np), width=1.0, height=1.0) if masked else None}
    got, want = _figures(lambda: t.plot(**kw_t)), _figures(lambda: j.plot(**kw_j))
    # Background and centres exactly; U/V within the interpolants' spread.
    _assert_figures_agree(
        [(label, [{**a, "quivers": []} for a in axes]) for label, axes in got],
        [(label, [{**a, "quivers": []} for a in axes]) for label, axes in want],
    )
    q_t, q_j = got[0][1][0]["quivers"][0], want[0][1][0]["quivers"][0]
    assert np.array_equal(q_t["X"], q_j["X"]) and np.array_equal(q_t["Y"], q_j["Y"])
    for key in "UV":
        assert np.abs(q_t[key] - q_j[key]).max() <= 2.0 * QUIVER_TOL


def test_plot_translation_of_a_colour_base_matches_jax():
    rng = _rng(9)
    base = np.stack([_textured(3), _textured(4), rng.random(REG_SHAPE).astype(np.float32) * 1.4 - 0.2], axis=-1)
    kw = {"N_patches": [2, 3], "rel_overlap": 0.2}
    j = da.TranslationAnalysis(da.OpticalImage(base, width=1.0, height=1.0), **kw)
    t = dt.TranslationAnalysis(dt.OpticalImage(torch.from_numpy(base), width=1.0, height=1.0), **kw)
    # One displacement for both (a smooth field of the points), so the
    # quiver is held to 1e-6 on what the plot itself computes.
    def field(points):
        x, y = np.asarray(points, dtype=float).T
        return np.stack([0.02 * x - 1.0, 0.5 + 0.01 * y])

    j.translation = field
    t.translation = field
    mask_np = rng.random(REG_SHAPE) > 0.5
    for reverse, mask in ((False, None), (True, mask_np)):
        got = _figures(
            lambda: t.plot_translation(
                reverse=reverse,
                scaling=3.0,
                mask=None if mask is None else dt.ScalarImage(torch.from_numpy(mask), width=1.0, height=1.0),
            )
        )
        want = _figures(
            lambda: j.plot_translation(
                reverse=reverse, scaling=3.0, mask=None if mask is None else da.ScalarImage(mask, width=1.0, height=1.0)
            )
        )
        _assert_figures_agree(got, want)
        quiver = got[0][1][0]["quivers"][0]
        assert quiver["U"].size == 6 and np.abs(quiver["U"]).min() > 0.1


def test_call_with_output_plots_and_returns_the_patch_translation(registrations):
    base, probe = registrations["base"], registrations["probe"]
    kw = {"N_patches": [3, 3], "rel_overlap": 0.3, "quality_tol": 0.01}
    j = da.DiffeomorphicImageRegistration(da.ScalarImage(base, width=1.0, height=1.0), **kw)
    t = dt.DiffeomorphicImageRegistration(dt.ScalarImage(torch.from_numpy(base), width=1.0, height=1.0), **kw)
    results = {}
    figures = {
        "jax": _figures(
            lambda: results.setdefault(
                "jax", j.call_with_output(da.ScalarImage(probe, width=1.0, height=1.0), True, True)
            )
        ),
        "port": _figures(
            lambda: results.setdefault(
                "port",
                t.call_with_output(
                    dt.ScalarImage(torch.from_numpy(probe), width=1.0, height=1.0),
                    plot_patch_translation=True,
                    return_patch_translation=True,
                ),
            )
        ),
    }
    assert len(figures["port"]) == len(figures["jax"]) == 1
    assert figures["port"][0][0] == "translation analysis"
    _, patches_t = results["port"]
    _, patches_j = results["jax"]
    assert patches_t.shape == (3, 3, 2) and np.abs(patches_t - patches_j).max() <= QUIVER_TOL
    assert _figures(lambda: t.call_with_output(dt.ScalarImage(torch.from_numpy(probe), width=1.0, height=1.0))) == []


@pytest.mark.parametrize("checker", ["ColorCheckerAfter2014", "ClassicColorChecker"])
def test_color_checker_plot_matches_jax(checker):
    _assert_figures_agree(
        _figures(lambda: getattr(dt, checker)().plot()),
        _figures(lambda: getattr(da, checker)().plot()),
    )
    swatches = _rng(5).random((4, 6, 3)).astype(np.float32)
    _assert_figures_agree(
        _figures(lambda: dt.CustomColorChecker(reference_colors=swatches).plot()),
        _figures(lambda: da.CustomColorChecker(reference_colors=swatches).plot()),
    )


def _image(pkg, array, **meta):
    data = array if pkg is da else torch.from_numpy(array)
    return pkg.OpticalImage(data, **META, **meta)


def _concentration_analysis(pkg, base, extra, verbosity):
    return pkg.ConcentrationAnalysis(
        base=[_image(pkg, base), _image(pkg, extra)],
        signal_reduction=pkg.MonochromaticReduction(color="gray"),
        balancing=pkg.LinearModel(scaling=1.5),
        model=pkg.LinearModel(scaling=2.0, offset=0.1),
        verbosity=verbosity,
        **{"diff option": "absolute"},
    )


@pytest.mark.parametrize("series", [False, True])
def test_concentration_analysis_verbosity_draws_and_changes_nothing(series):
    rng = _rng(21)
    base = rng.random(SHAPE + (3,)).astype(np.float32)
    extra = np.clip(base + 0.01 * rng.standard_normal(base.shape).astype(np.float32), 0, 1)
    probe = np.clip(base + 0.3 * (rng.random(base.shape) > 0.7), 0, 1).astype(np.float32)
    if series:
        probe = np.stack([probe, np.roll(probe, 2, axis=1)], axis=2)
    meta = {"series": True, "time": [0.0, 1.0]} if series else {}
    quiet = _concentration_analysis(dt, base, extra, 0)
    loud = _concentration_analysis(dt, base, extra, 2)
    loud_j = _concentration_analysis(da, base, extra, 2)
    assert loud.verbosity == 2 and quiet.verbosity == 0
    t_probe, j_probe = _image(dt, probe, **meta), _image(da, probe, **meta)
    assert _figures(lambda: quiet(t_probe)) == []
    results = {}
    got = _figures(lambda: results.setdefault("loud", loud(t_probe)))
    want = _figures(lambda: results.setdefault("jax", loud_j(j_probe)))
    assert [label for label, _ in got] == ["Difference", "Scalar signal", "Clean signal", "Balanced signal"]
    # The same figures; images within float32 rounding of the JAX package's
    # (the same stages on two libraries).
    _assert_figures_agree(got, want, tol=1e-6)
    assert torch.equal(results["loud"].img, quiet(t_probe).img)
    assert np.abs(results["loud"].img.numpy() - np.asarray(results["jax"].img)).max() <= 1e-6


def test_new_plots_name_matplotlib_where_it_is_absent(monkeypatch):
    import sys

    base = torch.from_numpy(_textured(2))
    ta = dt.TranslationAnalysis(dt.ScalarImage(base, width=1.0, height=1.0), N_patches=[2, 2], rel_overlap=0.2)
    reg = dt.ImageRegistration(dt.ScalarImage(base, width=1.0, height=1.0), N_patches=[2, 2], rel_overlap=0.2)
    loud = dt.ConcentrationAnalysis(verbosity=2)
    calls = {
        "TranslationAnalysis.plot_translation": lambda: ta.plot_translation(),
        "ImageRegistration.plot": lambda: reg.plot(),
        "call_with_output(plot_patch_translation=True)": lambda: reg._engine.call_with_output(
            dt.ScalarImage(base.clone(), width=1.0, height=1.0), plot_patch_translation=True
        ),
        "ColorChecker.plot": lambda: dt.ColorCheckerAfter2014().plot(),
        "ConcentrationAnalysis(verbosity=2)": lambda: loud(dt.ScalarImage(base.clone(), width=1.0, height=1.0)),
    }
    for name in [n for n in sys.modules if n.split(".")[0] == "matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    for what, call in calls.items():
        with pytest.raises(ImportError, match="matplotlib"):
            call()


def test_contour_is_exported_as_in_jax():
    assert dt.Contour is da.Contour is np.ndarray
    from darsia_tpu_torch.analysis import contour_smoother

    assert "Contour" in contour_smoother.__all__
