"""The port's colour embeddings against the JAX package.

The channel, range and path embeddings in absolute and relative mode, each
through ``to_scalar_image`` with a ``ColorEmbeddingRuntime`` on a rig-like
object (a baseline, labels and facies), on the same seeded 48x64 uint8
photograph; the range embedding's hue window across 0/360 degrees
(``tests/unit/test_signals_color.py``'s case); the registry parsed from a
TOML config by both packages; and the runtime's default device (the card).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.workflows.config import ColorEmbeddingRegistry as JaxRegistry
from darsia_tpu.signals.color.color_embedding import ColorRangeEmbeddingTransform as JaxRangeTransform
from darsia_tpu_torch.presets.workflows.config import ColorEmbeddingRegistry
from darsia_tpu_torch.signals.color.color_embedding import ColorRangeEmbeddingTransform

torch.set_num_threads(1)

H, W = 48, 64
META = {"width": 1.2, "height": 0.9}
#: Channel values: the same float32 conversions in both packages.
VALUE_TOL = 1e-6
#: Range masks may differ only where a value lies within this of a bound.
EDGE_TOL = 1e-6
#: Path embedding (tests/test_torch_color_path.py's ATOL).
PATH_TOL = 1e-6


def _photo(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.9, size=(H, W, 3)) * 255).astype(np.uint8)


def _labels() -> np.ndarray:
    labels = np.zeros((H, W), np.int64)
    labels[:, W // 2 :] = 1
    labels[H // 2 :, : W // 3] = 2
    return labels


def _rigs():
    base, labels = _photo(0), _labels()
    j = SimpleNamespace(
        baseline=da.OpticalImage(base, **META),
        labels=da.Image(labels, scalar=True, **META),
    )
    j.facies = j.labels
    t = SimpleNamespace(
        baseline=dt.OpticalImage(torch.from_numpy(base), **META),
        labels=dt.Image(torch.from_numpy(labels), scalar=True, **META),
    )
    t.facies = t.labels
    return j, t


def _run(embedding_j, embedding_t, photo):
    j_rig, t_rig = _rigs()
    j_out = embedding_j.to_scalar_image(da.OpticalImage(photo, **META), da.ColorEmbeddingRuntime(rig=j_rig))
    runtime = dt.ColorEmbeddingRuntime(rig=t_rig, device="cpu")
    t_out = embedding_t.to_scalar_image(dt.OpticalImage(torch.from_numpy(photo), **META), runtime)
    assert embedding_t.embedding_id in runtime.cache
    assert isinstance(t_out, dt.ScalarImage) and t_out.img.device.type == "cpu"
    assert t_out.img.dtype == torch.float32
    return np.asarray(j_out.img), t_out.img.numpy()


@pytest.mark.parametrize(
    "mode, color_space, channel",
    [
        ("absolute", "RGB", "g"),
        ("absolute", "BGR", "r"),
        ("absolute", "HSV", "h"),
        ("absolute", "HLS", "s"),
        ("absolute", "LAB", "b"),
        ("relative", "RGB", "r"),
        ("relative", "BGR", "b"),
    ],
)
def test_channel_embedding_against_jax(mode, color_space, channel):
    kw = dict(embedding_id="c", basis="global", color_space=color_space, channel=channel)
    j = da.ColorChannelEmbedding(mode=da.ColorMode(mode), **kw)
    t = dt.ColorChannelEmbedding(mode=dt.ColorMode(mode), **kw)
    want, got = _run(j, t, _photo(1))
    assert got.shape == (H, W)
    scale = 360.0 if color_space in ("HSV", "HLS") and channel == "h" else 100.0 if color_space == "LAB" else 1.0
    assert np.abs(got - want).max() <= VALUE_TOL * scale


def _mask_agreement(got, want, values, ranges) -> None:
    differ = got != want
    if differ.any():
        near = np.zeros(values.shape[:2], bool)
        for channel, bounds in enumerate(ranges):
            for bound in bounds:
                if bound is not None:
                    near |= np.abs(values[..., channel] - bound) <= EDGE_TOL * max(1.0, abs(bound))
        assert near[differ].all()


@pytest.mark.parametrize(
    "mode, color_space, ranges",
    [
        ("absolute", "HSV", [(40.0, 200.0), (0.2, None), (None, 0.8)]),
        ("absolute", "HSV", [(300.0, 60.0), (None, None), (None, None)]),
        ("absolute", "RGB", [(0.3, 0.7), (None, 0.5), (0.2, None)]),
        ("relative", "RGB", [(-0.1, 0.3), (None, None), (-0.5, 0.0)]),
    ],
)
def test_range_embedding_against_jax(mode, color_space, ranges):
    kw = dict(embedding_id="r", basis="global", calibration_root=".", color_space=color_space, ranges=ranges)
    j = da.ColorRangeEmbedding(mode=da.ColorMode(mode), **kw)
    t = dt.ColorRangeEmbedding(mode=dt.ColorMode(mode), **kw)
    photo = _photo(2)
    want, got = _run(j, t, photo)
    assert set(np.unique(got).tolist()) <= {0.0, 1.0} and 0 < got.mean() < 1
    base = dt.OpticalImage(torch.from_numpy(_photo(0)), **META)
    values, _ = dt.normalized_trichromatic(
        dt.OpticalImage(torch.from_numpy(photo), **META), color_space, dt.ColorMode(mode), base
    )
    _mask_agreement(got, want, values.numpy(), ranges)


def test_range_embedding_hue_wraparound():
    # tests/unit/test_signals_color.py: [350, 10] catches h = 0, not h = 240.
    data = np.stack([np.tile([1.0, 0.0, 0.0], (4, 1)), np.tile([0.0, 0.0, 1.0], (4, 1))])
    kw = dict(color_space="HSV", ranges=[(350.0, 10.0), (None, None), (None, None)])
    want = np.asarray(JaxRangeTransform(mode=da.ColorMode.ABSOLUTE, **kw)(da.Image(data, width=1, height=1)).img)
    got = ColorRangeEmbeddingTransform(mode=dt.ColorMode.ABSOLUTE, **kw)(
        dt.Image(torch.from_numpy(data), width=1, height=1)
    ).img.numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and not got[1].any()
    # At the wrap: 359.5 and 0.0 degrees in, 10.5 out.
    hsv = np.array([[[359.5, 1.0, 1.0], [0.0, 1.0, 1.0], [10.5, 1.0, 1.0]]], np.float32)
    rgb = dt.ops.color.hsv_to_rgb(torch.from_numpy(hsv))
    out = ColorRangeEmbeddingTransform(mode=dt.ColorMode.ABSOLUTE, **kw)(dt.Image(rgb, width=1, height=1))
    assert out.img.numpy().tolist() == [[1.0, 1.0, 0.0]]


def _color_paths(pkg, root, relative: bool):
    rng = np.random.default_rng(5)
    paths = {}
    for label in range(3):
        start = np.zeros(3) if relative else rng.uniform(0.1, 0.3, 3)
        steps = rng.uniform(0.05, 0.25, size=(3, 3)) * (1 if label % 2 else -1)
        colors = [start] + list(start + np.cumsum(steps, axis=0))
        paths[label] = pkg.ColorPath(colors=colors)
    pkg.LabelColorPathMap(paths).save(root / "color_paths" / "from_labels")


@pytest.mark.parametrize("mode", ["absolute", "relative"])
def test_path_embedding_against_jax(mode, tmp_path):
    # The paths are written by the port and read by both packages.
    _color_paths(dt, tmp_path, mode == "relative")
    kw = dict(embedding_id="p", basis="labels", calibration_root=tmp_path, num_segments=3)
    j = da.ColorPathEmbedding(mode=da.ColorMode(mode), **kw)
    t = dt.ColorPathEmbedding(mode=dt.ColorMode(mode), **kw)
    want, got = _run(j, t, _photo(3))
    assert got.shape == (H, W) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= PATH_TOL * max(1.0, np.abs(want).max())


def test_registry_from_toml_against_jax(tmp_path):
    toml = tmp_path / "config.toml"
    toml.write_text(
        """
[color.path.co2]
mode = "relative"
num_segments = 2
histogram_weighting = "wls"

[color.range.blue]
color_space = "hsv"
range = [[180, 260], [0.2, "none"], ["none", "none"]]

[color.channel.red]
color_space = "RGB"
channel = "R"
mode = "relative"

[color.channel.red.mask]
color_space = "HSV"
range = [[300, 60], ["none", "none"], ["none", "none"]]
"""
    )
    j = JaxRegistry().load(toml, results=tmp_path / "results")
    t = ColorEmbeddingRegistry().load(toml, results=tmp_path / "results")
    assert t.keys() == j.keys() == ["co2", "blue", "red"]
    for key in t.keys():
        a, b = vars(j[key]), vars(t[key])
        assert set(a) == set(b), key
        for name in a:
            if name == "mask_embedding" and a[name] is not None:
                assert vars(b[name])["ranges"] == vars(a[name])["ranges"]
            elif name in ("mode", "basis"):
                assert b[name].value == a[name].value
            else:
                assert b[name] == a[name], (key, name)
    with pytest.raises(KeyError, match="Available"):
        t.resolve("nope")


def test_runtime_defaults_to_the_card():
    _, t_rig = _rigs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dt.ColorEmbeddingRuntime(rig=t_rig)
        return
    runtime = dt.ColorEmbeddingRuntime(rig=t_rig)
    assert runtime.device == torch.device("cuda")
    embedding = dt.ColorChannelEmbedding(
        embedding_id="c", mode=dt.ColorMode.ABSOLUTE, basis="global", color_space="RGB", channel="r"
    )
    image = dt.OpticalImage(torch.from_numpy(_photo(1)), **META)
    assert embedding.to_scalar_image(image, runtime).img.is_cuda
