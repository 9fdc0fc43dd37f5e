"""The port's colour-path regression against the JAX package.

A seeded 48x64 scene of three labels under a mask, its baseline and three
photographs whose colours move along a bent path per label (with noise and
a strip of pixels shifted by exactly 0.1).  Both packages' spectra are compared with
their counts **equal** (integers, and in the same order: the fit reads them
in insertion order), with and without a baseline, with ``threshold_zero`` 0
and > 0 and with an ignore spectrum; the masked pixels counted as the zero
colour (the JAX package's quirk) are pinned.  The expanded spectra are equal,
the fitted nodes within ``NODE_TOL`` for every weighting and fit mode, and
the port's batched split errors equal, bit for bit, the plain version's
segment-by-segment numpy loop.
"""

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.signals.color import color_path_regression as cpr

torch.set_num_threads(1)

H, W, R = 48, 64, 25
#: Node colours are bin centres or their weighted means (float64 host
#: arithmetic in both packages).
NODE_TOL = 1e-12
PATHS = {
    0: [(0.0, 0.0, 0.0), (0.2, -0.1, 0.05), (0.35, -0.3, 0.1)],
    1: [(0.0, 0.0, 0.0), (-0.15, 0.1, 0.2), (-0.2, 0.3, 0.4)],
    2: [(0.0, 0.0, 0.0), (0.1, 0.1, -0.2), (0.3, 0.1, -0.3)],
}


def _scene(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = np.zeros((H, W), np.int32)
    labels[:, 20:] = 1
    labels[30:, 40:] = 2
    mask = rng.random((H, W)) > 0.15
    base = np.clip(0.45 + 0.05 * rng.standard_normal((H, W, 3)), 0, 1).astype(np.float32)
    photos = []
    for k in range(3):
        img = base.astype(np.float64).copy()
        for label, nodes in PATHS.items():
            t = rng.random((H, W)) * (k + 1) / 3
            seg = np.minimum((t * 2).astype(int), 1)
            frac = t * 2 - seg
            a, b = np.asarray(nodes)[seg], np.asarray(nodes)[seg + 1]
            colour = a + frac[..., None] * (b - a) + 0.01 * rng.standard_normal((H, W, 3))
            img = np.where((labels == label)[..., None], img + colour, img)
        img = np.clip(img, 0, 1).astype(np.float32)
        # A strip shifted by exactly 0.1 from the baseline.
        img[k, :8] = base[k, :8] + np.float32(0.1)
        photos.append(img)
    return {"labels": labels, "mask": mask, "base": base, "photos": photos}


def _regressions(scene, **kwargs):
    jax_reg = da.LabelColorPathMapRegression(
        labels=scene["labels"], resolution=R, mask=scene["mask"], **kwargs
    )
    port_reg = dt.LabelColorPathMapRegression(
        labels=torch.from_numpy(scene["labels"]), resolution=R, mask=torch.from_numpy(scene["mask"]), **kwargs
    )
    return jax_reg, port_reg


def _images(scene):
    jax_imgs = [da.Image(p, width=2.0, height=1.5) for p in scene["photos"]]
    port_imgs = [dt.Image(torch.from_numpy(p), width=2.0, height=1.5) for p in scene["photos"]]
    jax_base = da.Image(scene["base"], width=2.0, height=1.5)
    port_base = dt.Image(torch.from_numpy(scene["base"]), width=2.0, height=1.5)
    return jax_imgs, port_imgs, jax_base, port_base


def _items(spectra) -> dict:
    return {label: (list(s.counts.items()), s.base_color.tolist()) for label, s in spectra.items()}


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.mark.parametrize("with_baseline", [False, True])
@pytest.mark.parametrize("threshold_zero", [0.0, 0.05])
@pytest.mark.parametrize("with_ignore", [False, True])
def test_spectra_counts_equal_jax(scene, with_baseline, threshold_zero, with_ignore):
    jax_reg, port_reg = _regressions(scene)
    jax_imgs, port_imgs, jax_base, port_base = _images(scene)
    jax_ignore = port_ignore = None
    if with_ignore:
        # The expanded spectrum of the first photograph against the baseline.
        jax_ignore = jax_reg.expand_color_spectrum(jax_reg.get_color_spectrum(jax_imgs[:1], baseline=jax_base))
        port_ignore = port_reg.expand_color_spectrum(port_reg.get_color_spectrum(port_imgs[:1], baseline=port_base))
        assert _items(jax_ignore) == _items(port_ignore)
    jax_spectra = jax_reg.get_color_spectrum(
        jax_imgs,
        baseline=jax_base if with_baseline else None,
        ignore=jax_ignore,
        threshold_zero=threshold_zero,
        threshold_significant=1e-3,
    )
    port_spectra = port_reg.get_color_spectrum(
        port_imgs,
        baseline=port_base if with_baseline else None,
        ignore=port_ignore,
        threshold_zero=threshold_zero,
        threshold_significant=1e-3,
    )
    assert list(jax_spectra) == list(port_spectra) == [0, 1, 2]
    assert _items(jax_spectra) == _items(port_spectra)
    assert all(s.counts for s in port_spectra.values())


def test_masked_pixels_count_as_the_zero_colour(scene):
    """``threshold_zero == 0`` (the calibration default): a masked pixel adds
    one to its label's zero bin; ``threshold_zero > 0`` drops it."""
    _, port_reg = _regressions(scene)
    _, port_imgs, _, port_base = _images(scene)
    spectra = port_reg.get_color_spectrum(port_imgs[:1], baseline=port_base)
    zero = dt.flatten_index(dt.color_to_index(np.zeros(3), R, -np.ones(3), np.ones(3)), R)
    relative = scene["photos"][0].astype(np.float64) - scene["base"]
    for label in PATHS:
        inside = (scene["labels"] == label) & scene["mask"]
        masked = ((scene["labels"] == label) & ~scene["mask"]).sum()
        ids = dt.flatten_index(dt.color_to_index(relative[inside], R, -np.ones(3), np.ones(3)), R)
        assert spectra[label].counts.get(int(zero), 0) == masked + (ids == zero).sum()
    dropped = port_reg.get_color_spectrum(port_imgs[:1], baseline=port_base, threshold_zero=1e-9)
    for label in PATHS:
        assert sum(dropped[label].counts.values()) < sum(spectra[label].counts.values())


def test_a_label_without_colours_keeps_an_empty_spectrum(scene):
    jax_reg, port_reg = _regressions(scene)
    jax_imgs, port_imgs, jax_base, port_base = _images(scene)
    jax_spectra = jax_reg.get_color_spectrum(jax_imgs, baseline=jax_base, threshold_zero=5.0)
    port_spectra = port_reg.get_color_spectrum(port_imgs, baseline=port_base, threshold_zero=5.0)
    assert _items(jax_spectra) == _items(port_spectra)
    assert list(port_spectra) == [0, 1, 2] and not any(s.counts for s in port_spectra.values())
    paths = port_reg.find_color_path(port_spectra, num_segments=2)
    assert all(np.array_equal(np.asarray(p.relative_colors), np.zeros((3, 3))) for p in paths.values())


def test_base_colors_and_base_color_image(scene):
    jax_reg, port_reg = _regressions(scene, ignore_labels=[2])
    _, _, jax_base, port_base = _images(scene)
    jax_colors, port_colors = jax_reg.get_base_colors(jax_base), port_reg.get_base_colors(port_base)
    assert {k: v.tolist() for k, v in jax_colors.items()} == {k: v.tolist() for k, v in port_colors.items()}
    np.testing.assert_array_equal(
        np.asarray(jax_reg.base_color_image(jax_base).img), port_reg.base_color_image(port_base).img.numpy()
    )
    np.testing.assert_array_equal(jax_reg.get_mean_base_color(jax_base), port_reg.get_mean_base_color(port_base))


def test_expand_color_spectrum_equal(scene):
    jax_reg, port_reg = _regressions(scene)
    jax_imgs, port_imgs, jax_base, port_base = _images(scene)
    for iterations in (1, 2):
        jax_out = jax_reg.expand_color_spectrum(jax_reg.get_color_spectrum(jax_imgs, baseline=jax_base), iterations)
        port_out = port_reg.expand_color_spectrum(
            port_reg.get_color_spectrum(port_imgs, baseline=port_base), iterations
        )
        assert _items(jax_out) == _items(port_out)
        assert {k: v.occupancy for k, v in jax_out.items()} == {k: v.occupancy for k, v in port_out.items()}


@pytest.mark.parametrize("fit_mode", ["rdp", "lloyd"])
@pytest.mark.parametrize("weighting", ["threshold", "wls", "wls_sqrt", "wls_log"])
def test_find_color_path_against_jax(scene, weighting, fit_mode):
    jax_reg, port_reg = _regressions(scene, ignore_labels=[1] if weighting == "wls" else None)
    jax_imgs, port_imgs, jax_base, port_base = _images(scene)
    jax_spectra = jax_reg.get_color_spectrum(jax_imgs, baseline=jax_base)
    port_spectra = port_reg.get_color_spectrum(port_imgs, baseline=port_base)
    jax_ignore = jax_reg.get_color_spectrum(jax_imgs[:1], baseline=jax_imgs[0])
    port_ignore = port_reg.get_color_spectrum(port_imgs[:1], baseline=port_imgs[0])
    kwargs = {"num_segments": 2, "weighting": weighting, "fit_mode": fit_mode}
    jax_paths = jax_reg.find_color_path(jax_spectra, ignore=jax_ignore, **kwargs)
    port_paths = port_reg.find_color_path(port_spectra, ignore=port_ignore, **kwargs)
    assert list(jax_paths) == list(port_paths)
    for label in jax_paths:
        a = np.asarray(jax_paths[label].relative_colors)
        b = np.asarray(port_paths[label].relative_colors)
        assert a.shape == b.shape == (3, 3)
        np.testing.assert_allclose(b, a, rtol=0, atol=NODE_TOL)
        np.testing.assert_array_equal(port_paths[label].base_color, jax_paths[label].base_color)
        assert port_paths[label].name == jax_paths[label].name


def _cloud(n: int, seed: int) -> tuple:
    """A bent seeded cloud of n bin-centre colours with count weights."""
    rng = np.random.default_rng(seed)
    t = rng.random(n)
    bend = np.where(t < 0.5, t, 0.5)[:, None] * [0.6, -0.2, 0.1] + np.maximum(t - 0.5, 0)[:, None] * [0.1, 0.5, 0.4]
    colors = np.round((bend + 0.02 * rng.standard_normal((n, 3))) * 25) / 25
    colors = np.unique(colors, axis=0)
    weights = rng.random(len(colors)) + 0.1
    return colors, weights / weights.sum()


@pytest.mark.parametrize("seed", range(4))
def test_batched_split_errors_equal_the_plain_loop(seed):
    colors, _ = _cloud(300, seed)
    lens = np.linalg.norm(np.diff(colors, axis=0), axis=1)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(colors) - 3, 200)
    lengths = np.minimum(rng.integers(1, 120, 200), len(colors) - starts)
    got = cpr._segment_errors(torch.from_numpy(colors), lens, starts, lengths)
    want = [cpr._reference_segment_error(colors, range(p, p + L)) for p, L in zip(starts, lengths)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_segments", [1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_batched_rdp_equals_the_plain_version(seed, num_segments):
    colors, weights = _cloud(400, seed)
    embedding = cpr.LabelColorPathMapRegression._embed_1d(colors, weights)
    reg = dt.LabelColorPathMapRegression(labels=torch.zeros(2, 2, dtype=torch.int64))
    trace, trace_ref = [], []
    nodes = reg._fit_path_rdp(colors, weights, embedding, num_segments, trace)
    plain = reg._fit_path_rdp_reference(colors, weights, embedding, num_segments, trace_ref)
    np.testing.assert_array_equal(nodes, plain)
    assert [t[:3] for t in trace] == [t[:3] for t in trace_ref]
    for (_, _, _, d), (_, _, _, d_ref) in zip(trace, trace_ref):
        np.testing.assert_array_equal(d, d_ref)
    jax_nodes = da.LabelColorPathMapRegression(labels=np.zeros((2, 2), int))._fit_path_rdp(
        colors, weights, embedding, num_segments
    )
    np.testing.assert_array_equal(nodes, jax_nodes)


def test_regression_refuses_absolute_mode():
    with pytest.raises(NotImplementedError):
        dt.LabelColorPathMapRegression(labels=torch.zeros(2, 2), color_mode=dt.ColorMode.ABSOLUTE)
