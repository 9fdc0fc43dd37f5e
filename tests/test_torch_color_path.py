"""Parity of the port's colour paths and colour-path models with the JAX
package, on the CPU.

The same seeded numpy colours go through ``darsia_tpu`` and
``darsia_tpu_torch``: ``ColorPath.fit``, ``interpret`` and ``refine`` in
both colour modes and both parametrizations (as
``tests/fidelity/test_fidelity_colorpath.py`` covers them), the port-side
``interp`` against ``jnp.interp``, ``ColorPathInterpolation`` with and
without an ``ignore_spectrum``, ``LabelColorPathInterpolation``,
``get_mean_color`` and ``define_color_path``.

Tolerances: ``fit`` and the interpolations within ``ATOL`` = 1e-6 (float32
values of order 1; XLA may contract a multiply-add on the CPU that PyTorch
does not); ``interp`` within one ulp of the table's largest value (the lerp's
product may round once more than XLA's fused multiply-add);
``interpret`` and ``refine`` (float64 numpy in both) within 1e-12.  The
colours are built away from ties of ``fit``'s ``argmin`` (two segments
within 1e-6 of equally close that give different parameters), which the
tests check: there a last-bit difference could pick the other segment.
"""

import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.ops.interp import interp

torch.set_num_threads(1)

ATOL = 1e-6
TIE = 1e-6


def _colors():
    return [np.array([0.1, 0.1, 0.3]), np.array([0.3, 0.5, 0.4]), np.array([0.8, 0.7, 0.2]), np.array([0.9, 0.95, 0.1])]


def _paths():
    return da.ColorPath(colors=[c.copy() for c in _colors()]), dt.ColorPath(colors=[c.copy() for c in _colors()])


def _probe(seed: int, shape=(12, 13), scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape + (3,)) * scale).astype(np.float32)


def _away_from_ties(path, colors, color_mode, mode) -> None:
    """No colour has two segments within ``TIE`` of equally close that give
    different parameters (a colour closest to a node is as close to both of
    its segments, which give that node's parameter: no tie)."""
    interp, l1 = path.fit_terms(torch.from_numpy(colors), color_mode, mode)
    near = l1 <= l1.min(dim=-1, keepdim=True).values + TIE
    spread = torch.where(near, interp, -torch.inf).amax(-1) - torch.where(near, interp, torch.inf).amin(-1)
    assert float(spread.max()) <= ATOL


@pytest.mark.parametrize("color_mode", ["absolute", "relative"])
@pytest.mark.parametrize("mode", ["relative", "equidistant"])
def test_fit_against_jax(color_mode, mode):
    j, t = _paths()
    colors = _probe(41) if color_mode == "absolute" else _probe(42, scale=0.6) - 0.3
    _away_from_ties(t, colors, dt.ColorMode(color_mode), mode)
    want = np.asarray(j.fit(colors, da.ColorMode(color_mode), mode=mode))
    got = t.fit(torch.from_numpy(colors), dt.ColorMode(color_mode), mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= ATOL
    # Outside the path's range the open end segments extrapolate.
    assert got.min() < 0 or got.max() > 1


@pytest.mark.parametrize("color_mode", ["absolute", "relative"])
@pytest.mark.parametrize("mode", ["relative", "equidistant"])
def test_interpret_and_refine_against_jax(color_mode, mode):
    j, t = _paths()
    params = np.linspace(-0.2, 1.2, 29)
    want = j.interpret(params, da.ColorMode(color_mode), mode=mode)
    got = t.interpret(params, dt.ColorMode(color_mode), mode=mode)
    assert np.abs(got - want).max() <= 1e-12
    on_tensor = t.interpret(torch.from_numpy(params), dt.ColorMode(color_mode), mode=mode)
    assert on_tensor.dtype == torch.float64 and np.abs(on_tensor.numpy() - want).max() <= 1e-12
    # fit inverts interpret on the path.
    inner = params[(params >= 0) & (params <= 1)]
    back = t.fit(torch.from_numpy(t.interpret(inner, dt.ColorMode(color_mode), mode=mode)), dt.ColorMode(color_mode), mode=mode)
    assert np.abs(back.numpy() - inner).max() <= 1e-5
    for left, right in ((None, None), (-0.1, 1.1)):
        rj, rt = j.refine(6, left, right, mode=mode), t.refine(6, left, right, mode=mode)
        assert rt.num_segments == rj.num_segments
        assert np.abs(np.asarray(rt.colors) - np.asarray(rj.colors)).max() <= 1e-12
        assert np.allclose(rt.relative_distances, rj.relative_distances, atol=1e-12)


def test_color_path_io_against_jax(tmp_path):
    j, t = _paths()
    j.save(tmp_path / "jax")
    t.save(tmp_path / "port")
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    back = dt.ColorPath.load(tmp_path / "jax.json")
    assert back.to_dict() == j.to_dict() == dt.ColorPath.from_dict(t.to_dict()).to_dict()
    np.testing.assert_array_equal(np.asarray(t.sample_absolute_color_path(9)), np.asarray(j.sample_absolute_color_path(9)))
    # The path is drawn with matplotlib; where it does not import, the call
    # names it.
    with mock.patch.dict(sys.modules, {"matplotlib.pyplot": None}):
        with pytest.raises(ImportError, match="matplotlib"):
            t.show_path()


def test_fit_keeps_its_constants_per_device():
    _, t = _paths()
    colors = torch.from_numpy(_probe(3))
    t.fit(colors, dt.ColorMode.ABSOLUTE)
    first = t._segments(dt.ColorMode.ABSOLUTE, "relative", torch.device("cpu"))
    t.fit(colors, dt.ColorMode.ABSOLUTE)
    assert t._segments(dt.ColorMode.ABSOLUTE, "relative", torch.device("cpu")) is first
    t.colors[1] = t.colors[1] + 0.01  # a changed path is uploaded again
    assert t._segments(dt.ColorMode.ABSOLUTE, "relative", torch.device("cpu")) is not first


# ---------------------------------------------------------------- interp


INTERP_CASES = {
    "nodes": ([0.0, 0.25, 0.5, 1.0], [0.0, 0.3, 0.35, 2.0], [0.0, 0.25, 0.5, 1.0, 0.5, 0.25]),
    "duplicate supports": ([0.0, 0.4, 0.4, 0.4, 1.0], [0.0, 0.1, 0.5, 0.7, 1.0], [0.39999, 0.4, 0.40001, 0.7]),
    "outside": ([-0.5, 0.0, 2.0], [1.0, 1.5, -1.0], [-3.0, -0.5000001, 2.0000002, 7.0, np.inf, -np.inf]),
    "one segment": ([0.2, 0.8], [3.0, 5.0], [0.1, 0.2, 0.5, 0.8, 0.9]),
}


@pytest.mark.parametrize("case", list(INTERP_CASES))
def test_interp_against_jnp_interp(case):
    xp, fp, fixed = INTERP_CASES[case]
    xp, fp = np.asarray(xp, np.float32), np.asarray(fp, np.float32)
    x = np.concatenate([np.asarray(fixed, np.float32), np.random.default_rng(1).uniform(xp[0] - 1, xp[-1] + 1, 200).astype(np.float32)])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ulp = np.spacing(np.abs(fp).max())
    assert np.nanmax(np.abs(got - want)) <= ulp
    with pytest.raises(ValueError):
        interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp[:-1]))


# ---------------------------------------------------------------- models


def _spectra():
    """The same relative-colour spectrum fitted by each package (JAX, port)."""
    colors = np.random.default_rng(5).uniform(-0.3, 0.3, size=(200, 3))
    return tuple(
        pkg.ColorSpectrum(resolution=11).fit(colors).threshold(0.01) for pkg in (da, dt)
    )


@pytest.mark.parametrize("color_mode", ["absolute", "relative"])
@pytest.mark.parametrize("with_spectrum", [False, True], ids=["plain", "ignore_spectrum"])
def test_color_path_interpolation_against_jax(color_mode, with_spectrum):
    j, t = _paths()
    spectra = _spectra() if with_spectrum else (None, None)
    spectrum = spectra[1]
    values = [0.0, 0.4, 1.0, 1.5]
    colors = _probe(44, scale=1.2) - 0.1
    colors[:3] *= 0.01  # norms below 0.1: ignored with a spectrum
    _away_from_ties(t, colors, dt.ColorMode(color_mode), "equidistant")
    jm = da.ColorPathInterpolation(j, da.ColorMode(color_mode), values=values)
    tm = dt.ColorPathInterpolation(t, dt.ColorMode(color_mode), values=values, ignore_spectrum=spectrum)
    # The JAX evaluation reads only whether a spectrum is there.
    jm.ignore_spectrum = spectra[0]
    want = np.asarray(jm.call_array(colors))
    got = tm(torch.from_numpy(colors))
    assert got.dtype == torch.float32 and np.abs(got.numpy() - want).max() <= ATOL
    if spectrum is not None:
        assert np.all(got.numpy()[:3] == values[0])
    if color_mode == "absolute":
        # Past the end nodes: linear extrapolation with the end slopes.
        assert got.max() > 1.5 or got.min() < 0.0
    image = dt.OpticalImage(torch.from_numpy(colors), width=1.0, height=1.0)
    out = tm(image)
    assert isinstance(out, dt.OpticalImage) and torch.equal(out.img, got)


def test_color_path_interpolation_io_keeps_the_spectrum(tmp_path):
    _, t = _paths()
    j_spectrum, spectrum = _spectra()
    model = dt.ColorPathInterpolation(t, dt.ColorMode.RELATIVE, values=[0, 0.3, 0.6, 1.0], ignore_spectrum=spectrum)
    model.save(tmp_path / "interp")
    back = dt.ColorPathInterpolation.load(tmp_path / "interp.json")
    assert isinstance(back.ignore_spectrum, dt.ColorSpectrum)
    assert back.ignore_spectrum.counts == spectrum.counts and back.to_dict() == model.to_dict()
    # The JAX package reads the port's file and writes the same one.
    j_back = da.ColorPathInterpolation.load(tmp_path / "interp.json")
    assert j_back.ignore_spectrum.counts == spectrum.counts
    j, _ = _paths()
    jm = da.ColorPathInterpolation(j, da.ColorMode.RELATIVE, values=[0, 0.3, 0.6, 1.0], ignore_spectrum=j_spectrum)
    assert jm.to_dict() == model.to_dict()
    # A file without a spectrum, written by the JAX package, reads back.
    j, _ = _paths()
    da.ColorPathInterpolation(j, da.ColorMode.ABSOLUTE, values=[0, 0.2, 0.5, 1.0]).save(tmp_path / "jax")
    loaded = dt.ColorPathInterpolation.load(tmp_path / "jax.json")
    assert loaded.ignore_spectrum is None and loaded.values.tolist() == [0, 0.2, 0.5, 1.0]
    assert loaded.color_mode == dt.ColorMode.ABSOLUTE and str(loaded).startswith("ColorPathInterpolation")
    with pytest.raises(NotImplementedError):
        loaded.calibrate()


def test_label_color_path_interpolation_against_jax():
    labels = np.zeros((12, 13), int)
    labels[:, 6:] = 1
    labels[:2] = 5  # a label without a path stays 0
    colors = _probe(45)
    out = []
    for pkg in (da, dt):
        paths = {
            0: pkg.ColorPath(colors=[c.copy() for c in _colors()]),
            1: pkg.ColorPath(colors=[np.zeros(3), np.array([1.0, 0.5, 0.2])]),
        }
        lab = labels if pkg is da else torch.from_numpy(labels)
        model = pkg.LabelColorPathInterpolation(paths, lab, pkg.ColorMode.ABSOLUTE, values={1: [0.0, 2.0]})
        model.update_model_parameters({0: [0.0, 0.2, 0.6, 1.0]})
        out.append(model(colors if pkg is da else torch.from_numpy(colors)))
    assert np.abs(out[1].numpy() - np.asarray(out[0])).max() <= ATOL
    assert (out[1].numpy()[:2] == 0).all()


def test_get_mean_color_and_define_color_path_against_jax():
    rng = np.random.default_rng(46)
    image = rng.random((20, 24, 3)).astype(np.float32)
    mask = rng.random((20, 24)) > 0.3
    for robust in (True, False):
        for m in (None, mask):
            want = da.get_mean_color(image, m, robust=robust)
            got = dt.get_mean_color(torch.from_numpy(image), None if m is None else torch.from_numpy(m), robust=robust)
            assert np.abs(got - want).max() <= 1e-6
    line = np.linspace(0, 1, 24, dtype=np.float32)[None, :, None] * np.array([0.8, 0.4, -0.3], np.float32) + 0.1
    line = np.broadcast_to(line, (20, 24, 3)) + rng.standard_normal((20, 24, 3)).astype(np.float32) * 1e-3
    want = da.define_color_path(line, mask, num_colors=4)
    got = dt.define_color_path(torch.from_numpy(np.ascontiguousarray(line)), torch.from_numpy(mask), num_colors=4)
    assert np.abs(np.asarray(got.colors) - np.asarray(want.colors)).max() <= 1e-6
    with pytest.raises(ValueError, match="Not enough"):
        dt.define_color_path(torch.from_numpy(image), torch.zeros((20, 24), dtype=torch.bool))


def test_embedding_basis_against_jax():
    for value in (None, "labels", " FACIES ", dt.ColorEmbeddingBasis.GLOBAL):
        want = da.parse_color_embedding_basis(value if not isinstance(value, dt.ColorEmbeddingBasis) else value.value)
        assert dt.parse_color_embedding_basis(value).value == want.value
    assert dt.calibration_basis_folder("global") == da.calibration_basis_folder("global") == "from_global"
