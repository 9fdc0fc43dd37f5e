"""Parity of the port's threshold models with the JAX package, on the CPU.

Static thresholds (homogeneous and per label, with an upper bound, a mask,
``return_float`` and ``update_model_parameters``) are bitwise equal.  The
dynamic models (Otsu and two-peak, homogeneous and per label, with a mask)
give the same thresholds, bitwise, because the port's histogram counts on
the tensor's device equal ``np.histogram``'s exactly: that is checked on
values that sit exactly on the bin edges, on constant values (numpy's
+-0.5 widening), and on the top value.  The ``ThresholdModel`` facade maps
method names as the JAX package does.
"""

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.signals.models.dynamicthresholdmodel import label_histograms

torch.set_num_threads(1)

H, W = 40, 64


def np_of(x) -> np.ndarray:
    x = x.img if hasattr(x, "img") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def labels_of(seed=0, num=4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, num, (H, W)), axis=0) * 3 + 1  # labels 1, 4, 7, 10


def bimodal(seed=0, labels=None) -> np.ndarray:
    """Two modes per label, their positions shifted per label."""
    rng = np.random.default_rng(seed)
    shift = 0.0 if labels is None else 0.02 * labels
    lo = rng.normal(0.2, 0.03, (H, W)) + shift
    hi = rng.normal(0.7, 0.03, (H, W)) + shift
    return np.where(rng.random((H, W)) < 0.5, lo, hi).astype(np.float32)


def edge_values(bins=256) -> np.ndarray:
    """Float32 values, many exactly on np.histogram's bin edges."""
    rng = np.random.default_rng(5)
    first, last = np.float32(0.1), np.float32(0.9)
    edges = np.linspace(np.float64(first), np.float64(last), bins + 1)
    on_edges = edges[rng.integers(0, bins + 1, 1500)].astype(np.float32)
    spread = rng.uniform(first, last, 1000).astype(np.float32)
    vals = np.concatenate([[first, last], on_edges, spread, np.float32(edges[1:-1]).astype(np.float32)])
    rng.shuffle(vals)
    return vals


@pytest.mark.parametrize(
    "values",
    [
        edge_values(),
        np.full(50, 0.3, np.float32),
        np.array([0.0, 1.0, 1.0, 0.5, 0.25], np.float32),
        np.random.default_rng(2).normal(0, 1, 4000).astype(np.float32),
    ],
    ids=["on_edges", "constant", "top_value", "normal"],
)
@pytest.mark.parametrize("bins", [256, 7])
def test_histogram_counts_equal_numpy(values, bins):
    groups = torch.zeros(values.shape, dtype=torch.int64)
    counts, edges, sizes = label_histograms(torch.from_numpy(values), groups, 1, bins)
    ref_counts, ref_edges = np.histogram(values.astype(np.float64), bins=bins)
    np.testing.assert_array_equal(counts[0], ref_counts)
    np.testing.assert_array_equal(edges[0], ref_edges)
    assert sizes[0] == values.size


def test_label_histograms_equal_numpy_per_label_and_skip_excluded():
    values = edge_values()[:2000]
    rng = np.random.default_rng(7)
    groups = rng.integers(-1, 4, values.shape)  # -1: in no group
    groups[groups == 2] = 3  # group 2 empty
    counts, edges, sizes = label_histograms(
        torch.from_numpy(values), torch.from_numpy(groups), 4, 256
    )
    for g in range(4):
        chosen = values[groups == g].astype(np.float64)
        assert sizes[g] == chosen.size
        if chosen.size == 0:
            assert counts[g].sum() == 0 and np.isnan(edges[g]).all()
            continue
        ref_counts, ref_edges = np.histogram(chosen, bins=256)
        np.testing.assert_array_equal(counts[g], ref_counts)
        np.testing.assert_array_equal(edges[g], ref_edges)


@pytest.mark.parametrize("per_label", [False, True])
@pytest.mark.parametrize("upper", [None, "set"])
@pytest.mark.parametrize("mask", [False, True])
def test_static_threshold_is_bitwise(per_label, upper, mask):
    labels = labels_of() if per_label else None
    signal = bimodal(1)
    lower = [0.3, 0.45, 0.5, 0.25] if per_label else 0.45
    upper_v = None if upper is None else ([0.8, 0.75, 0.9, 0.7] if per_label else 0.75)
    region = np.random.default_rng(3).random((H, W)) < 0.7 if mask else None
    out = {}
    for pkg in (da, dt):
        model = pkg.StaticThresholdModel(lower, upper_v, labels=labels)
        given = torch.from_numpy(signal) if pkg is dt else signal
        given_mask = None if region is None else (torch.from_numpy(region) if pkg is dt else region)
        out[pkg] = np_of(model(given, given_mask))
    assert out[dt].dtype == np.bool_
    np.testing.assert_array_equal(out[dt], out[da])


def test_static_threshold_return_float_images_and_update():
    labels = labels_of()
    signal = bimodal(2)
    out = {}
    for pkg in (da, dt):
        model = pkg.StaticThresholdModel([0.3, 0.4, 0.5, 0.6], [0.9] * 4, labels=labels, return_float=True)
        img = pkg.ScalarImage(torch.from_numpy(signal) if pkg is dt else signal, width=2.0, height=1.0)
        first = np_of(model(img))
        model.update_model_parameters(np.array([0.5, 0.55, 0.6, 0.65, 0.8, 0.8, 0.85, 0.85]))
        second = np_of(model(img.img))
        homogeneous = pkg.StaticThresholdModel(0.2, 0.6, return_float=True)
        homogeneous.update_model_parameters([0.4, 0.7])
        third = np_of(homogeneous(img.img))
        out[pkg] = (first, second, third)
    for port, ref in zip(out[dt], out[da]):
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port, ref)
    assert not np.array_equal(out[dt][0], out[dt][1])


@pytest.mark.parametrize("method", ["otsu", "two-peak"])
@pytest.mark.parametrize("per_label", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_dynamic_threshold_matches_jax(method, per_label, mask):
    labels = labels_of(4) if per_label else None
    signal = bimodal(4, labels)
    region = np.random.default_rng(6).random((H, W)) < 0.8 if mask else None
    out = {}
    for pkg in (da, dt):
        model = pkg.DynamicThresholdModel(
            method=method, threshold_min=0.1, threshold_max=0.9, labels=labels
        )
        given = torch.from_numpy(signal) if pkg is dt else signal
        given_mask = None if region is None else (torch.from_numpy(region) if pkg is dt else region)
        result = np_of(model(given, given_mask))
        out[pkg] = (result, np.atleast_1d(np.asarray(model._threshold_lower, dtype=float)))
    np.testing.assert_array_equal(out[dt][1], out[da][1])
    np.testing.assert_array_equal(out[dt][0], out[da][0])
    if method == "otsu":  # between the modes (two-peak follows the noisy bins)
        assert ((out[dt][1] > 0.3) & (out[dt][1] < 0.8)).all()


def test_dynamic_threshold_keeps_a_label_without_data():
    labels = labels_of(8)
    signal = bimodal(8, labels)
    region = labels != 4  # label 4 fully masked
    out = {}
    for pkg in (da, dt):
        model = pkg.DynamicThresholdModel(
            key="x ", labels=labels, threshold_min=0.1, threshold_max=0.9, **{"x threshold": 0.33}
        )
        given = torch.from_numpy(signal) if pkg is dt else signal
        model(given, torch.from_numpy(region) if pkg is dt else region)
        out[pkg] = np.asarray(model._threshold_lower, dtype=float)
    np.testing.assert_array_equal(out[dt], out[da])
    assert out[dt][1] == 0.33


@pytest.mark.parametrize(
    "analyzer",
    ["StandardOtsu", "TwoPeakHistogrammAnalysis", "GlobalMinTwoPeakHistogrammAnalysis", "OtsuTwoPeakHistogrammAnalysis"],
)
def test_histogram_analyses_match_jax(analyzer):
    values = np.concatenate([edge_values()[:1200], bimodal(9).ravel()])
    one_mode = np.random.default_rng(9).normal(0.5, 0.01, 500).astype(np.float32)
    for data in (values, one_mode, np.zeros(0, np.float32)):
        ref = getattr(da, analyzer)()(data)
        assert getattr(dt, analyzer)()(torch.from_numpy(data)) == ref
        assert getattr(dt, analyzer)()(data) == ref  # numpy in: numpy's histogram
    assert dt.otsu_threshold(torch.from_numpy(values)) == da.otsu_threshold(values)


@pytest.mark.parametrize(
    "method, mapped",
    [
        ("tailored global min", "two-peak"),
        ("two-peak", "two-peak"),
        ("otsu", "otsu"),
        ("tailored otsu", "otsu"),
        ("global min", "two-peak"),
    ],
)
def test_threshold_model_maps_method_names_as_jax(method, mapped):
    options = {
        "x threshold dynamic": True,
        "x threshold method": method,
        "x threshold value min": 0.1,
        "x threshold value max": 0.9,
    }
    signal = bimodal(10)
    out = {}
    for pkg in (da, dt):
        model = pkg.ThresholdModel(key="x ", **options)
        assert model.model.method == mapped
        out[pkg] = np_of(model(torch.from_numpy(signal) if pkg is dt else signal))
    np.testing.assert_array_equal(out[dt], out[da])


def test_threshold_model_static_dispatch_and_update():
    labels = labels_of(11)
    signal = bimodal(11)
    out = {}
    for pkg in (da, dt):
        model = pkg.ThresholdModel(labels, key="prior ", **{"prior threshold value": [0.3, 0.4, 0.5, 0.6]})
        first = np_of(model(torch.from_numpy(signal) if pkg is dt else signal))
        model.update_model_parameters([0.6, 0.5, 0.4, 0.3])
        second = np_of(model(torch.from_numpy(signal) if pkg is dt else signal))
        out[pkg] = (first, second)
    for port, ref in zip(out[dt], out[da]):
        np.testing.assert_array_equal(port, ref)
