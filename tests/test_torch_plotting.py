"""The display layer: every drawing function of the port against the JAX
package's, on matplotlib's Agg backend.

Each function runs in both packages on the same seeded inputs (the port's on
CPU tensors) with ``plt.show``, ``plt.pause`` and ``plt.close`` patched out,
so every figure either draws stays open; the figures' artists are then
compared: titles, labels, image arrays and colour maps, line data, contour
levels and paths, quiver U/V, collections' paths and colours, colour bars
(as axes), legends.  Figures agree exactly except where the port reduces on
the device: the W1 flux norm (1e-6 relative) and the image statistics'
profiles (float64 on the device against numpy's float32 mean: 1e-6
relative).  ``plot_contour_on_image(return_image=True)`` and every plot
built on it return RGB arrays bitwise equal to the JAX package's; saved
PNG and JPEG files decode to equal arrays.  ``show_plotly`` is compared
through recording stand-ins for ``plotly.express`` and
``plotly.graph_objects`` (plotly is not installed here, and both packages'
``show_plotly`` raise naming it).  Where matplotlib does not import, every
port function raises ``ImportError`` naming it.
"""

import sys
from types import SimpleNamespace
from unittest import mock

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.image import imread as read_png  # noqa: E402

import darsia_tpu as da  # noqa: E402
import darsia_tpu_torch as dt  # noqa: E402

torch.set_num_threads(1)

RNG = np.random.default_rng(2024)


# ------------------------------------------------------------------ helpers


def _plain(x):
    if isinstance(x, np.ma.MaskedArray):
        return {"data": np.asarray(x.data, dtype=float), "mask": np.ma.getmaskarray(x)}
    return np.asarray(x)


def _collection(c) -> dict:
    out = {
        "type": type(c).__name__,
        "paths": [p.vertices for p in c.get_paths()],
        "edgecolor": np.asarray(c.get_edgecolor()),
        "facecolor": np.asarray(c.get_facecolor()),
        "alpha": c.get_alpha(),
        "linewidth": np.asarray(c.get_linewidth()),
        "label": c.get_label(),
    }
    if hasattr(c, "levels"):
        out["levels"] = np.asarray(c.levels)
    for key in ("U", "V", "X", "Y"):
        if hasattr(c, key):
            out[key] = _plain(getattr(c, key))
    return out


def _line(line) -> dict:
    data = line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_data()
    return {
        "data": [np.asarray(d, dtype=float) for d in data],
        "label": line.get_label(),
        "color": line.get_color(),
        "marker": line.get_marker(),
        "linestyle": line.get_linestyle(),
    }


def describe(fig) -> dict:
    """The artists of a figure as plain data."""
    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append(
            {
                "label": ax.get_label(),
                "title": ax.get_title(),
                "xlabel": ax.get_xlabel(),
                "ylabel": ax.get_ylabel(),
                "axis_on": ax.axison,
                "images": [
                    {"array": _plain(im.get_array()), "cmap": im.get_cmap().name, "alpha": im.get_alpha()}
                    for im in ax.images
                ],
                "lines": [_line(line) for line in ax.get_lines()],
                "collections": [_collection(c) for c in ax.collections],
                "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
            }
        )
    return {"label": fig.get_label(), "axes": axes}


def assert_same(got, want, rtol=0.0, where="figure"):
    """Equal structure; arrays equal (within ``rtol`` of their scale)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            assert_same(got[key], want[key], rtol, f"{where}.{key}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, f"{where}[{k}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, where
        if want.dtype.kind in "fc" and rtol:
            scale = max(np.abs(want).max(initial=0.0), 1e-30)
            assert np.abs(got.astype(float) - want.astype(float)).max(initial=0.0) <= rtol * scale, where
        else:
            assert np.array_equal(got, want), where
    else:
        assert got == want, (where, got, want)


def drawn(fn, *args, **kwargs):
    """(return value, descriptions of the figures ``fn`` drew, show calls)."""
    before = set(plt.get_fignums())
    shown = []
    with mock.patch.object(plt, "close", lambda *a, **k: None), mock.patch.object(
        plt, "show", lambda *a, **k: shown.append(k)
    ), mock.patch.object(plt, "pause", lambda *a, **k: None):
        out = fn(*args, **kwargs)
    figures = [plt.figure(n) for n in sorted(set(plt.get_fignums()) - before)]
    described = [describe(f) for f in figures]
    plt.close("all")
    return out, described, shown


def both(jax_call, port_call, rtol=0.0):
    """Draw with both packages and compare; returns the port's results."""
    out_j, figs_j, shown_j = drawn(jax_call)
    out_t, figs_t, shown_t = drawn(port_call)
    assert figs_j, "the JAX call drew nothing"
    assert_same(figs_t, figs_j, rtol)
    assert shown_t == shown_j
    return out_j, out_t, figs_t


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ plotting.py


def test_plot_2d_wasserstein_distance(tmp_path):
    info = {
        "flux": RNG.standard_normal((44, 30, 2)).astype(np.float32),
        "pressure": RNG.standard_normal((44, 30)).astype(np.float32),
        "mass_diff": RNG.standard_normal((44, 30)).astype(np.float32),
    }
    port_info = {k: t(v) for k, v in info.items()}
    both(
        lambda: da.plotting.plot_2d_wasserstein_distance(info, show=False, scale=5.0),
        lambda: dt.plotting.plot_2d_wasserstein_distance(port_info, show=False, scale=5.0),
        rtol=1e-6,
    )
    _, _, figs = both(
        lambda: da.plotting.plot_2d_wasserstein_distance(info),
        lambda: dt.plotting.plot_2d_wasserstein_distance(port_info),
        rtol=1e-6,
    )
    quiver = figs[0]["axes"][2]["collections"][0]
    u = quiver["U"]["data"] if isinstance(quiver["U"], dict) else quiver["U"]
    assert quiver["type"] == "Quiver" and u.size == 22 * 15


# ------------------------------------------------------------ Image.show


def _image_cases():
    scalar = RNG.random((12, 16)).astype(np.float32)
    colour = (RNG.random((12, 16, 3)) * 1.4 - 0.2).astype(np.float32)  # clipped
    colour_u8 = (RNG.random((12, 16, 3)) * 255).astype(np.uint8)
    series = RNG.random((12, 16, 3)).astype(np.float32)
    volume = RNG.random((6, 8, 10)).astype(np.float32)
    return {
        "scalar": (scalar, {"scalar": True, "name": "conc"}, {"cmap": "magma"}),
        "colour": (colour, {}, {"title": "float colour"}),
        "colour_u8": (colour_u8, {}, {}),
        "series": (series, {"scalar": True, "series": True, "time": [0.0, 1.0, 2.0]}, {"duration": 0.01}),
        "volume": (volume, {"scalar": True, "space_dim": 3, "dimensions": [0.6, 0.8, 1.0]}, {}),
    }


@pytest.mark.parametrize("case", list(_image_cases()))
def test_image_show_matches_jax(case):
    data, meta, kwargs = _image_cases()[case]
    meta = {"width": 1.6, "height": 1.2, **meta} if meta.get("space_dim", 2) == 2 else meta
    jax_image, port_image = da.Image(data, **meta), dt.Image(t(data), **meta)
    for method in ("show", "show_matplotlib", "show_plain"):
        _, _, figs = both(lambda: getattr(jax_image, method)(**kwargs), lambda: getattr(port_image, method)(**kwargs))
        assert len(figs) == (3 if case == "series" else 1)


class _Recorder:
    """A stand-in for ``plotly.express`` / ``plotly.graph_objects``: each
    call returns a record of its name and arguments."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: {"call": name, "args": list(args), "kwargs": kwargs}


@pytest.mark.parametrize(
    "case,kwargs",
    [
        ("scalar2d", {}),
        ("series2d", {}),
        ("uint8", {}),
        ("volume", {"threshold": 0.4}),
        ("volume", {"threshold": 0.3, "relative": True}),
        ("volume", {"view": "voxel"}),
        ("series3d", {"view": "scatter"}),
        ("scalar2d", {"surpress_2d": True}),
        ("volume", {"surpress_3d": True}),
    ],
)
def test_plotly_figures_match_jax(case, kwargs):
    cases = {
        "scalar2d": (RNG.random((5, 7)).astype(np.float32), {"scalar": True, "width": 1.4, "height": 1.0}),
        "series2d": (
            RNG.random((5, 7, 2)).astype(np.float32),
            {"scalar": True, "series": True, "time": [0.0, 30.0], "width": 1.4, "height": 1.0},
        ),
        "uint8": ((RNG.random((5, 7, 3)) * 255).astype(np.uint8), {"width": 1.4, "height": 1.0}),
        "volume": (RNG.random((4, 5, 6)).astype(np.float32), {"scalar": True, "space_dim": 3, "dimensions": [0.4, 0.5, 0.6]}),
        "series3d": (
            RNG.random((4, 5, 6, 2)).astype(np.float32),
            {"scalar": True, "space_dim": 3, "dimensions": [0.4, 0.5, 0.6], "series": True, "time": [0.0, 1.0]},
        ),
    }
    data, meta = cases[case]
    px, go = _Recorder(), _Recorder()
    want = da.Image(data, **meta)._plotly_figures(px, go, "title", **kwargs)
    got = dt.Image(t(data), **meta)._plotly_figures(px, go, "title", **kwargs)
    assert_same(got, want)
    assert len(want) == (0 if any(k.startswith("surpress") for k in kwargs) else meta.get("series", False) + 1)


def test_show_plotly_names_plotly():
    image = dt.ScalarImage(torch.zeros(4, 5))
    with mock.patch.dict(sys.modules, {"plotly": None, "plotly.express": None}):
        with pytest.raises(ImportError, match="plotly"):
            image.show_plotly()
        with pytest.raises(ImportError, match="plotly"):
            da.ScalarImage(np.zeros((4, 5))).show_plotly()


# ------------------------------------------------------ augmented_plotting


def _background_and_masks(shape=(30, 40)):
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    background = np.stack([xx / shape[1], yy / shape[0], 0.5 + 0 * xx], -1).astype(np.float32)
    blob = ((yy - 14) ** 2 + (xx - 18) ** 2 < 60).astype(np.float32)
    band = ((xx > 25) & (yy > 5)).astype(np.float32)
    return background, [blob, band]


@pytest.mark.parametrize(
    "kwargs",
    [
        {"color": "g"},
        {"color": [(255, 64, 0), (0, 127, 255)], "alpha": [0.8, 0.3], "thickness": 3},
        {"color": (0.2, 0.4, 0.6), "linewidth": 1.5, "title": "two masks"},
    ],
)
def test_plot_contour_on_image_matches_jax(tmp_path, kwargs):
    background, masks = _background_and_masks()
    rgb_j, rgb_t, _ = both(
        lambda: da.plot_contour_on_image(img=da.Image(background), mask=masks, path=tmp_path / "j.png", return_image=True, **kwargs),
        lambda: dt.plot_contour_on_image(
            img=dt.Image(t(background)), mask=[t(m) > 0.5 for m in masks], path=tmp_path / "t.png",
            return_image=True, **kwargs,
        ),
    )
    assert rgb_t.dtype == np.uint8 and np.array_equal(rgb_t, rgb_j)
    assert np.array_equal(read_png(tmp_path / "t.png"), read_png(tmp_path / "j.png"))
    single_j, single_t, _ = both(
        lambda: da.plot_contour_on_image(background, masks[0], show=True),
        lambda: dt.plot_contour_on_image(dt.Image(t(background)), dt.ScalarImage(t(masks[0])), show=True),
    )
    assert single_t is not None and single_j is not None


def test_plot_distribution_on_image_matches_jax(tmp_path):
    background, masks = _background_and_masks()
    field = RNG.random(masks[0].shape).astype(np.float32)
    both(
        lambda: da.plot_distribution_on_image(background, field, alpha=0.4, cmap="plasma", title="d", path=tmp_path / "j.png"),
        lambda: dt.plot_distribution_on_image(dt.Image(t(background)), dt.ScalarImage(t(field)), alpha=0.4, cmap="plasma", title="d", path=tmp_path / "t.png"),
    )
    assert np.array_equal(read_png(tmp_path / "t.png"), read_png(tmp_path / "j.png"))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("colour", [False, True])
def test_plot_image_statistics_matches_jax(axis, colour):
    shape = (36, 50, 3) if colour else (36, 50)
    data = (RNG.random(shape) * 3 + 1).astype(np.float32)
    _, _, figs = both(
        lambda: da.plot_image_statistics(data, axis=axis, title="stats"),
        lambda: dt.plot_image_statistics(dt.Image(t(data)), axis=axis, title="stats"),
        rtol=1e-6,
    )
    lines = figs[0]["axes"][0]["lines"]
    assert lines[0]["label"] == "mean" and len(lines[0]["data"][1]) == shape[axis]
    # The profiles against a float64 reckoning.
    mean, std = dt.utils.augmented_plotting._statistics(t(data), axis)
    ref = data.astype(np.float64).mean(-1) if colour else data.astype(np.float64)
    assert np.abs(mean - ref.mean(1 - axis)).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(std - ref.std(1 - axis)).max() <= 1e-6 * np.abs(ref).max()
    u8 = (data * 50).astype(np.uint8)
    mean8, _ = dt.utils.augmented_plotting._statistics(t(u8), axis)
    ref8 = u8.mean(-1) if colour else u8
    assert mean8.dtype == np.float64 and np.allclose(mean8, ref8.mean(axis=1 - axis), rtol=1e-12)


# ------------------------------------------------- multiphase time series


def _results(pkg, shape=(30, 40)):
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    ramp = (np.exp(-((yy - 14) ** 2 + (xx - 18) ** 2) / 80.0)).astype(np.float32)
    fields = {
        "normalized_signal_aq": ramp,
        "normalized_signal_g": ramp**2,
        "mass": 3.0 * ramp,
        "saturation_g": ramp**1.5,
        "concentration_co2_aq": 0.2 * ramp,
    }
    convert = t if pkg is dt else np.asarray
    return SimpleNamespace(**{k: pkg.ScalarImage(convert(v)) for k, v in fields.items()})


@pytest.mark.parametrize("what", ["plot_mass_over_time", "plot_volume_over_time"])
def test_time_series_plots_match_jax(tmp_path, what):
    series = [pkg.MultiphaseTimeSeriesAnalysis(None) for pkg in (da, dt)]
    for s in series:
        for k in range(5):
            s.data.append(0.5 * k, 1.0 + k, 0.4 * k, 1.0 + 0.6 * k, 0.01 * k)
    both(lambda: getattr(series[0], what)(), lambda: getattr(series[1], what)())
    both(lambda: getattr(series[0], what)(tmp_path / "j.png"), lambda: getattr(series[1], what)(tmp_path / "t.png"))
    assert np.array_equal(read_png(tmp_path / "t.png"), read_png(tmp_path / "j.png"))


def test_plot_result_matches_jax(tmp_path):
    analyses = [pkg.MultiphaseTimeSeriesAnalysis(None) for pkg in (da, dt)]
    results = [_results(da), _results(dt)]
    both(
        lambda: analyses[0].plot_result(results[0], "mass", tmp_path / "j.png", vmax=2.0),
        lambda: analyses[1].plot_result(results[1], "mass", tmp_path / "t.png", vmax=2.0),
    )
    assert np.array_equal(read_png(tmp_path / "t.png"), read_png(tmp_path / "j.png"))


def test_contour_signal_and_mass_match_jax(tmp_path):
    analyses = [pkg.MultiphaseTimeSeriesAnalysis(None) for pkg in (da, dt)]
    results = [_results(da), _results(dt)]
    background, _ = _background_and_masks()
    images = [da.Image(background), dt.Image(t(background))]
    rgb_j, rgb_t, _ = both(
        lambda: analyses[0].plot_contour_signal(images[0], results[0], [0.2, 0.5], [0.3], tmp_path / "j.png"),
        lambda: analyses[1].plot_contour_signal(images[1], results[1], [0.2, 0.5], [0.3], tmp_path / "t.png"),
    )
    assert np.array_equal(rgb_t, rgb_j)
    rgb_j, rgb_t, _ = both(
        lambda: analyses[0].plot_contour_mass(images[0], results[0], [0.5, 1.0, 2.5], None, thickness=2),
        lambda: analyses[1].plot_contour_mass(images[1], results[1], [0.5, 1.0, 2.5], None, thickness=2),
    )
    assert np.array_equal(rgb_t, rgb_j)


RUN_PLOTS = [
    ("plot_pure_contour_signal", ("aqueous", 0.3)),
    ("plot_pure_contour_signal", ("gaseous", 0.2)),
    ("plot_simple_contour_signal", ()),
    ("plot_contour_saturation_concentration", ()),
    ("plot_contour_saturation", ()),
    ("plot_contour_concentration", ()),
    ("plot_dissolved_CO2", ()),
    ("plot_gas", ()),
]


@pytest.mark.parametrize("name,extra", RUN_PLOTS)
def test_simple_run_analysis_plots_match_jax(name, extra):
    runs = [pkg.SimpleRunAnalysis(None) for pkg in (da, dt)]
    results = [_results(da), _results(dt)]
    background, _ = _background_and_masks()
    images = [da.Image(background), dt.Image(t(background))]

    def call(k):
        if name in ("plot_dissolved_CO2", "plot_gas"):
            return lambda: getattr(runs[k], name)(images[k], images[k], results[k], None, thickness=3)
        return lambda: getattr(runs[k], name)(images[k], results[k], *extra, None, thickness=3)

    rgb_j, rgb_t, _ = both(call(0), call(1))
    assert rgb_t.dtype == np.uint8 and np.array_equal(rgb_t, rgb_j)


# ------------------------------------------------ logs and model plots


def test_co2_mass_analysis_log_matches_jax(tmp_path):
    baselines = [da.Image(np.zeros((20, 30, 3), np.float32), width=2.0, height=1.0),
                 dt.Image(torch.zeros(20, 30, 3), width=2.0, height=1.0)]
    analyses = [pkg.CO2MassAnalysis(b, 1.01, 23.0) for pkg, b in zip((da, dt), baselines)]
    both(lambda: analyses[0].log(tmp_path / "jax"), lambda: analyses[1].log(tmp_path / "port"))
    for name in ("density_gaseous_co2", "solubility_co2"):
        assert np.array_equal(read_png(tmp_path / "port" / f"{name}.png"), read_png(tmp_path / "jax" / f"{name}.png"))


def test_pw_transformation_log_matches_jax(tmp_path):
    supports, values = [-0.5, 0, 0.25, 0.4, 1.0, 3.0], [0, 0, 0.1, 0.3, 1.2, 2.0]
    both(
        lambda: da.PWTransformation(supports, values).log(tmp_path / "j.png"),
        lambda: dt.PWTransformation(supports, values).log(tmp_path / "t.png"),
        rtol=1e-6,
    )
    assert (tmp_path / "t.png").stat().st_size > 0
    _, figs, _ = drawn(lambda: dt.PWTransformation(supports, values).log(None))
    assert figs == []


def _color_paths():
    colors = [np.array([0.1, 0.2, 0.3]), np.array([0.5, 0.3, 0.2]), np.array([0.9, 0.8, 1.2])]
    return [pkg.ColorPath(colors=colors, name="path") for pkg in (da, dt)]


def test_color_path_maps_and_views_match_jax():
    paths = _color_paths()
    cmaps = [p.get_color_map(17, name="m") for p in paths]
    assert cmaps[1].name == cmaps[0].name == "m" and cmaps[1].N == 17
    assert np.array_equal(cmaps[1].colors, cmaps[0].colors)
    assert paths[1].get_color_map().name == "path"
    both(lambda: paths[0].show_cmap(), lambda: paths[1].show_cmap())
    both(lambda: paths[0].show_path(), lambda: paths[1].show_path())
    maps = [pkg.LabelColorPathMap({0: p, 3: p}) for pkg, p in zip((da, dt), paths)]
    _, _, figs = both(lambda: maps[0].show_cmaps(), lambda: maps[1].show_cmaps())
    assert len(figs[0]["axes"][0]["images"]) == 2
    both(lambda: maps[0].show_paths(), lambda: maps[1].show_paths())


def test_mass_computation_show_matches_jax():
    from test_torch_color_to_mass import build_chain

    computations = []
    for pkg in (da, dt):
        chain, _, geom = build_chain(pkg)
        workflows = da.presets.workflows if pkg is da else dt.presets.workflows
        computations.append(
            workflows.MassComputation(chain.color_analysis.base, geom, pkg.SimpleFlash(0.05, 0.5, 0.5, 1.0), chain.co2_mass_analysis)
        )
    both(lambda: computations[0].show(), lambda: computations[1].show())


def test_global_calibration_flash_and_preview_plots_match_jax(tmp_path):
    from test_torch_color_to_mass import EXPERIMENT, _analysis, build_chain

    labels = np.zeros((48, 64), np.int32)
    labels[:, 32:] = 1
    histories = []
    for pkg in (da, dt):
        chain, img, geom = build_chain(pkg)
        workflows = da.presets.workflows if pkg is da else dt.presets.workflows
        mc = workflows.MassComputation(chain.color_analysis.base, geom, pkg.SimpleFlash(0.05, 0.5, 0.5, 1.0), chain.co2_mass_analysis)
        analysis, _ = _analysis(pkg, labels, np.full((48, 64, 3), 0.5, np.float32))
        histories.append(
            drawn(lambda: analysis.global_calibration_flash(mc, None, [img], EXPERIMENT, show=True))
        )
        session = chain.manual_calibration_session([img], EXPERIMENT)
        histories.append(drawn(lambda: session.preview(path=tmp_path / f"{pkg.__name__}.png")))
    for k in (0, 1):
        (out_j, figs_j, shown_j), (out_t, figs_t, shown_t) = histories[k], histories[k + 2]
        assert_same(figs_t, figs_j, rtol=1e-6)
        assert shown_t == shown_j and figs_j
    assert histories[2][0]["integrated_mass"] == pytest.approx(histories[0][0]["integrated_mass"], rel=1e-6)
    assert (tmp_path / "darsia_tpu_torch.png").stat().st_size > 0


def test_write_contours_to_file_matches_jax(tmp_path):
    from test_torch_fluidflower import analysis_class, scene

    configs = scene(tmp_path, layered=False)
    for pkg, name, extra in ((da, "jax", {}), (dt, "port", {"device": "cpu"})):
        analysis = analysis_class(pkg, False)(
            baseline=tmp_path / "base.npz", config=configs[name], results=tmp_path / f"results_{name}", **extra
        )
        analysis.single_image_analysis(tmp_path / "img.npz", write_contours_to_file=True)
    files = [tmp_path / f"results_{n}" / "contour_plots" / "img_with_contours.jpg" for n in ("jax", "port")]
    assert np.array_equal(read_png(files[1]), read_png(files[0]))


def test_model_calibration_plot_matches_jax():
    from darsia_tpu.analysis.model_calibration import AbstractModelObjective as JaxObjective
    from darsia_tpu_torch.analysis.model_calibration import AbstractModelObjective as PortObjective

    class Jax(JaxObjective):
        def _convert_signal(self, img, diff):
            return img * diff

    class Port(PortObjective):
        def _convert_signal(self, img, diff):
            return img * diff

    arrays = [RNG.random((10, 12)).astype(np.float32) for _ in range(6)]
    times = [0.0, 1.5, 3.0]
    jax_images = [da.ScalarImage(a, width=1.2, height=1.0) for a in arrays]
    port_images = [dt.ScalarImage(t(a), width=1.2, height=1.0) for a in arrays]
    geometries = [pkg.Geometry(**im.shape_metadata()) for pkg, im in ((da, jax_images[0]), (dt, port_images[0]))]
    both(
        lambda: Jax()._visualize_model_calibration(jax_images[:3], jax_images[3:], times, {"geometry": geometries[0]}),
        lambda: Port()._visualize_model_calibration(port_images[:3], port_images[3:], times, {"geometry": geometries[1]}),
        rtol=1e-6,
    )


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_curvature_show_image_matches_jax(dtype):
    data = RNG.random((20, 30, 3)) * 1.3
    data = (data * 200).astype(np.uint8) if dtype == np.uint8 else data.astype(np.float32)
    config = {"init": {"horizontal_bulge": 0.0}}
    corrections = [da.CurvatureCorrection(config=config, image=data), dt.CurvatureCorrection(config=config, image=t(data))]
    both(lambda: corrections[0].show_image(), lambda: corrections[1].show_image())


# ------------------------------------------------- without matplotlib


def _port_calls(tmp_path):
    background, masks = _background_and_masks()
    image = dt.Image(t(background))
    results = _results(dt)
    series = dt.MultiphaseTimeSeriesAnalysis(None)
    series.data.append(0.0, 1.0, 0.5, 0.5, 0.0)
    info = {k: torch.zeros(8, 8, *s) for k, s in (("flux", (2,)), ("pressure", ()), ("mass_diff", ()))}
    return {
        "Image.show": lambda: image.show(),
        "plot_2d_wasserstein_distance": lambda: dt.plotting.plot_2d_wasserstein_distance(info),
        "plot_contour_on_image": lambda: dt.plot_contour_on_image(image, masks[0]),
        "plot_distribution_on_image": lambda: dt.plot_distribution_on_image(image, masks[0]),
        "plot_image_statistics": lambda: dt.plot_image_statistics(image),
        "plot_mass_over_time": lambda: series.plot_mass_over_time(),
        "plot_result": lambda: series.plot_result(results, "mass", tmp_path / "x.png"),
        "plot_contour_mass": lambda: series.plot_contour_mass(image, results, [0.5], None),
        "plot_gas": lambda: dt.SimpleRunAnalysis(None).plot_gas(image, image, results, None),
        "CO2MassAnalysis.log": lambda: dt.CO2MassAnalysis(image, 1.01, 23.0).log(tmp_path / "log"),
        "PWTransformation.log": lambda: dt.PWTransformation([0, 1], [0, 1]).log(tmp_path / "pw.png"),
        "ColorPath.get_color_map": lambda: _color_paths()[1].get_color_map(),
        "ColorPath.show_path": lambda: _color_paths()[1].show_path(),
        "CurvatureCorrection.show_image": lambda: dt.CurvatureCorrection(config={}, image=t(background)).show_image(),
    }


def test_every_drawing_function_names_matplotlib_where_it_is_absent(tmp_path, monkeypatch):
    calls = _port_calls(tmp_path)
    for name in [n for n in sys.modules if n.split(".")[0] == "matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    for what, call in calls.items():
        with pytest.raises(ImportError, match="matplotlib"):
            call()
