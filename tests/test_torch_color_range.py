"""The port's colour ranges, spectra and label maps against the JAX package.

The quantisation (float64, round half to even) of numpy arrays and of CPU
tensors against the JAX functions, with the negative-box case of
``tests/unit/test_signals_color.py`` and exact half-steps; fits, histograms,
dilation and membership of seeded colours; and the saved files of each
package read by the other.  Host results are compared exactly.
"""

import json

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)


def _colors(n=400, seed=0, lo=0.0, hi=1.0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 3))


@pytest.mark.parametrize(
    "box", [None, (-np.ones(3), np.ones(3)), (np.array([0.1, -0.2, 0.0]), np.array([0.9, 0.4, 2.0]))]
)
@pytest.mark.parametrize("resolution", [11, 51])
def test_color_to_index_against_jax(box, resolution):
    lo, hi = box if box is not None else (None, None)
    colors = _colors(500, seed=1, lo=-1.2, hi=1.2)
    want = da.color_to_index(colors, resolution, lo, hi)
    np.testing.assert_array_equal(dt.color_to_index(colors, resolution, lo, hi), want)
    got = dt.color_to_index(torch.from_numpy(colors), resolution, lo, hi)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # float32 colours go through float64 in both.
    c32 = colors.astype(np.float32)
    np.testing.assert_array_equal(
        dt.color_to_index(torch.from_numpy(c32), resolution, lo, hi).numpy(),
        da.color_to_index(c32, resolution, lo, hi),
    )
    ids = dt.flatten_index(want, resolution)
    np.testing.assert_array_equal(ids, da.flatten_index(want, resolution))
    np.testing.assert_array_equal(dt.unflatten_index(ids, resolution), want)
    np.testing.assert_array_equal(
        dt.index_to_color(want, resolution, lo, hi), da.index_to_color(want, resolution, lo, hi)
    )


def test_negative_box_and_half_steps():
    # tests/unit/test_signals_color.py::test_negative_box_quantization
    colors = np.array([[-0.5, 0.0, 0.5]])
    idx = dt.color_to_index(colors, 11, -np.ones(3), np.ones(3))
    np.testing.assert_array_equal(idx, da.color_to_index(colors, 11, -np.ones(3), np.ones(3)))
    assert np.allclose(dt.index_to_color(idx, 11, -np.ones(3), np.ones(3)), colors, atol=0.1)
    # Exact half-steps of [0, 1] at resolution 5 (bins of 0.25): 0.125 ->
    # 0.5 -> 0, 0.375 -> 1.5 -> 2, 0.625 -> 2.5 -> 2 (half to even).
    halves = np.array([[0.125, 0.375, 0.625], [0.875, 0.0, 1.0]])
    want = np.array([[0, 2, 2], [4, 0, 4]])
    np.testing.assert_array_equal(da.color_to_index(halves, 5), want)
    np.testing.assert_array_equal(dt.color_to_index(halves, 5), want)
    np.testing.assert_array_equal(dt.color_to_index(torch.from_numpy(halves), 5).numpy(), want)


def test_color_range_against_jax():
    colors = _colors(seed=2, lo=0.2, hi=0.7)
    j, t = da.ColorRange().fit(colors, expand=0.1), dt.ColorRange().fit(colors, expand=0.1)
    np.testing.assert_array_equal(t.min_color, j.min_color)
    np.testing.assert_array_equal(t.max_color, j.max_color)
    probe = _colors(300, seed=3)
    want = j.contains(probe)
    np.testing.assert_array_equal(t.contains(probe), want)
    np.testing.assert_array_equal(t.contains(torch.from_numpy(probe)).numpy(), want)
    assert t.to_dict() == j.to_dict()
    back = dt.ColorRange.load_from_dict(j.to_dict())
    np.testing.assert_array_equal(back.max_color, j.max_color)
    assert back.color_mode == dt.ColorMode.ABSOLUTE


def _images(pkg, n=2):
    rng = np.random.default_rng(4)
    base = rng.uniform(0.3, 0.5, size=(12, 16, 3)).astype(np.float32)
    images = [base + rng.uniform(0, 0.2, size=base.shape).astype(np.float32) for _ in range(n)]
    mask = np.zeros((12, 16), bool)
    mask[2:9, 3:12] = True
    if pkg is dt:
        wrap = lambda a: dt.OpticalImage(torch.from_numpy(a), width=1, height=1)  # noqa: E731
        return [wrap(a) for a in images], wrap(base), torch.from_numpy(mask)
    wrap = lambda a: da.OpticalImage(a, width=1, height=1)  # noqa: E731
    return [wrap(a) for a in images], wrap(base), mask


@pytest.mark.parametrize("relative", [False, True])
def test_from_images_against_jax(relative):
    (ji, jb, jm), (ti, tb, tm) = _images(da), _images(dt)
    for cls in ("ColorRange", "DiscreteColorRange"):
        j = getattr(da, cls).from_images(ji, baseline=jb if relative else None, mask=jm)
        t = getattr(dt, cls).from_images(ti, baseline=tb if relative else None, mask=tm)
        assert t.to_dict() == j.to_dict()


def test_discrete_range_against_jax(tmp_path):
    colors = _colors(300, seed=5, lo=0.4, hi=0.6)
    j = da.DiscreteColorRange(resolution=11).fit(colors)
    t = dt.DiscreteColorRange(resolution=11).fit(colors)
    assert t.occupancy == j.occupancy and t.shape == j.shape
    np.testing.assert_array_equal(t.colors(flat=True), j.colors(flat=True))
    probe = np.concatenate([colors, _colors(300, seed=6)])
    want = j.contains(probe)
    np.testing.assert_array_equal(t.contains(probe), want)
    np.testing.assert_array_equal(t.contains(torch.from_numpy(probe)).numpy(), want)
    np.testing.assert_array_equal(t.flat_color_index(probe[0]), j.flat_color_index(probe[0]))
    np.testing.assert_array_equal(t.flat_color_index(probe), j.flat_color_index(probe))
    j.expand(2)
    t.expand(2)
    assert t.occupancy == j.occupancy
    np.testing.assert_array_equal(t.contains(torch.from_numpy(probe)).numpy(), j.contains(probe))
    assert t.to_dict() == j.to_dict()
    assert dt.DiscreteColorRange.load_from_dict(j.to_dict()).occupancy == j.occupancy
    # Saved files, both ways.
    j.save(tmp_path / "j")
    t.save(tmp_path / "t")
    assert dt.DiscreteColorRange.load(tmp_path / "j").occupancy == j.occupancy
    assert da.DiscreteColorRange.load(tmp_path / "t").occupancy == t.occupancy


def test_color_spectrum_against_jax(tmp_path):
    rng = np.random.default_rng(7)
    colors = np.concatenate([np.full((90, 3), 0.5), rng.uniform(0.0, 0.2, size=(10, 3))])
    more = rng.uniform(0.0, 1.0, size=(50, 3))
    j = da.ColorSpectrum(resolution=11, base_color=[0.1, 0.2, 0.3]).fit(colors).accumulate(more)
    t = dt.ColorSpectrum(resolution=11, base_color=[0.1, 0.2, 0.3]).fit(colors).accumulate(more)
    assert t.counts == j.counts and t.occupancy == j.occupancy
    np.testing.assert_array_equal(t.colors, j.colors)
    np.testing.assert_array_equal(t.probabilities, j.probabilities)
    probe = rng.uniform(-0.1, 1.1, size=(7, 9, 3))
    np.testing.assert_array_equal(t.weight(probe), j.weight(probe))
    np.testing.assert_array_equal(t.weight(torch.from_numpy(probe)).numpy(), j.weight(probe))
    np.testing.assert_array_equal(t.distance(probe), j.distance(probe))
    np.testing.assert_allclose(t.distance(torch.from_numpy(probe)).numpy(), j.distance(probe), atol=1e-15)
    assert t.distance(probe[0, 0]) == j.distance(probe[0, 0])
    for mode in ("RELATIVE", "ABSOLUTE"):
        want = j.in_spectrum(probe, getattr(da.ColorMode, mode))
        np.testing.assert_array_equal(t.in_spectrum(probe, getattr(dt.ColorMode, mode)), want)
        got = t.in_spectrum(torch.from_numpy(probe), getattr(dt.ColorMode, mode))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t.in_spectrum(probe, "neither")
    j.threshold(0.05)
    t.threshold(0.05)
    assert t.counts == j.counts
    other_j = da.DiscreteColorRange(resolution=11).fit(np.full((1, 3), 0.5))
    other_t = dt.DiscreteColorRange(resolution=11).fit(np.full((1, 3), 0.5))
    assert t.remove(other_t).counts == j.remove(other_j).counts
    assert t.to_dict() == j.to_dict()
    assert dt.ColorSpectrum.from_dict(j.to_dict()).counts == j.counts
    j.save(tmp_path / "j")
    t.save(tmp_path / "t")
    assert dt.ColorSpectrum.load(tmp_path / "j").to_dict() == j.to_dict()
    assert da.ColorSpectrum.load(tmp_path / "t").to_dict() == t.to_dict()
    empty = dt.ColorSpectrum(resolution=11)
    assert empty.distance(probe) == 0.0 and empty.relative_colors.shape == (0, 3)


def test_label_maps_both_ways(tmp_path):
    def paths(pkg):
        return pkg.LabelColorPathMap(
            {
                0: pkg.ColorPath(colors=[np.zeros(3), np.ones(3)], name="a"),
                3: pkg.ColorPath(colors=[np.zeros(3), np.array([1.0, 0, 0]), np.array([1.0, 0.5, 0])]),
            }
        )

    paths(da).save(tmp_path / "jax_paths")
    paths(dt).save(tmp_path / "port_paths")
    for file in sorted((tmp_path / "jax_paths").glob("*.json")):
        assert json.loads(file.read_text()) == json.loads((tmp_path / "port_paths" / file.name).read_text())
    loaded = dt.LabelColorPathMap.load(tmp_path / "jax_paths")
    assert set(loaded) == {0, 3} and isinstance(loaded[3], dt.ColorPath)
    assert set(da.LabelColorPathMap.load(tmp_path / "port_paths")) == {0, 3}
    refined = dt.LabelColorPathMap.refine(loaded, num_segments=4)
    j_refined = da.LabelColorPathMap.refine(paths(da), num_segments=4)
    for label in (0, 3):
        np.testing.assert_allclose(np.array(refined[label].colors), np.array(j_refined[label].colors), atol=1e-12)

    cmap = {1: np.array([0.1, 0.2, 0.3]), 4: np.array([0.3, 0.2, 0.1])}
    da.LabelColorMap(cmap).save(tmp_path / "jax_colors")
    t_map = dt.LabelColorMap.load(tmp_path / "jax_colors")
    assert t_map.labels() == [1, 4]
    np.testing.assert_array_equal(t_map.mean(), da.LabelColorMap(cmap).mean())
    dt.LabelColorMap(cmap).save(tmp_path / "port_colors")
    assert (tmp_path / "port_colors.json").read_text() == (tmp_path / "jax_colors.json").read_text()

    spectra = {
        label: (pkg.ColorSpectrum(resolution=11).fit(_colors(50, seed=label)))
        for pkg in (da,)
        for label in (2, 5)
    }
    da.LabelColorSpectrumMap(spectra).save(tmp_path / "jax_spectra")
    t_spectra = dt.LabelColorSpectrumMap.load(tmp_path / "jax_spectra")
    assert {k: v.counts for k, v in t_spectra.items()} == {k: v.counts for k, v in spectra.items()}
    t_spectra.save(tmp_path / "port_spectra")
    back = da.LabelColorSpectrumMap.load(tmp_path / "port_spectra")
    assert {k: v.counts for k, v in back.items()} == {k: v.counts for k, v in spectra.items()}

