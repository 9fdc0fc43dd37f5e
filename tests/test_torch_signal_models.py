"""Parity of the port's region selector and linear models with the JAX
package, on the CPU.

``BinaryDataSelector`` with each of its five criteria (value, relative
value, value/value extra color, gradient modulus, and a combined one built
directly) keeps the same regions: bitwise equal masks.  ``ScalingModel``
and ``HeterogeneousLinearModel`` (before and after ``update`` and
``update_model_parameters``) agree within 1e-7 (float32 values of order 1;
XLA may contract the multiply-add on the CPU, PyTorch does not).
"""

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 48, 64


def np_of(x) -> np.ndarray:
    x = x.img if hasattr(x, "img") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def regions_scene(seed=0):
    """A signal with blobs of different strength, a mask of the blobs and
    noise specks, and an RGB difference image."""
    rng = np.random.default_rng(seed)
    signal = rng.uniform(0.0, 0.01, (H, W))
    mask = np.zeros((H, W), bool)
    for k, (r, c, size) in enumerate([(8, 8, 6), (30, 10, 8), (10, 40, 5), (35, 45, 9), (24, 28, 3)]):
        strength = 0.01 + 0.02 * k
        signal[r : r + size, c : c + size] += strength * (1 + rng.uniform(0, 1, (size, size)))
        mask[r : r + size, c : c + size] = True
    mask |= rng.random((H, W)) < 0.01
    diff = rng.uniform(0, 0.1, (H, W, 3))
    diff[30:38, 10:18, 2] += 0.5
    diff[35:44, 45:54, 2] += 0.3
    return signal.astype(np.float32), mask, diff.astype(np.float32)


CRITERIA = [
    {"posterior criterion": "value", "posterior threshold": 0.05},
    {"posterior criterion": "relative value", "posterior threshold": 3.0},
    {
        "posterior criterion": "value/value extra color",
        "posterior threshold": [0.03, 0.35],
        "posterior extra color": "blue",
    },
    {"posterior criterion": "gradient modulus", "posterior threshold": 0.02},
]


@pytest.mark.parametrize("options", CRITERIA, ids=lambda o: o["posterior criterion"])
@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensors"])
def test_selector_criteria_are_bitwise(options, tensors):
    signal, mask, diff = regions_scene()
    out = {}
    for pkg in (da, dt):
        selector = pkg.BinaryDataSelector(key="posterior ", **options)
        args = (signal, mask, diff)
        if pkg is dt and tensors:
            args = tuple(torch.from_numpy(a) for a in args)
        out[pkg] = np.asarray(selector(*args))
    assert out[dt].dtype == np.bool_
    np.testing.assert_array_equal(out[dt], out[da])
    assert 0 < out[dt].sum() < mask.sum()  # some regions kept, some dropped


def test_combined_criterion_and_empty_mask():
    signal, mask, diff = regions_scene(1)
    out = {}
    for pkg in (da, dt):
        criterion = pkg.CombinedCriterion(
            [pkg.ValueCriterion(0.04), pkg.RelativeValueCriterion(2.0)]
        )
        selector = pkg.BinaryDataSelector(criterion)
        kept = np.asarray(selector(signal, mask, diff))
        empty = np.asarray(selector(signal, np.zeros_like(mask), diff))
        out[pkg] = (kept, empty)
    for port, ref in zip(out[dt], out[da]):
        np.testing.assert_array_equal(port, ref)
    assert not out[dt][1].any()


def test_selector_refuses_an_unknown_criterion():
    for pkg in (da, dt):
        with pytest.raises(ValueError, match="not supported"):
            pkg.BinaryDataSelector(key="x ", **{"x criterion": "area"})


def test_scaling_model_matches_jax():
    signal = np.random.default_rng(2).uniform(0, 1, (H, W)).astype(np.float32)
    out = {}
    for pkg in (da, dt):
        model = pkg.ScalingModel(key="m ", **{"m scaling": 1.7})
        first = np_of(model(torch.from_numpy(signal) if pkg is dt else signal))
        model.update_model_parameters([0.3], dofs=["scaling"])
        second = np_of(model(torch.from_numpy(signal) if pkg is dt else signal))
        out[pkg] = (first, second)
    for port, ref in zip(out[dt], out[da]):
        assert np.abs(port - ref).max() <= 1e-7
    with pytest.raises(ValueError):
        dt.ScalingModel().update_model_parameters([1.0], dofs=["offset"])


@pytest.mark.parametrize("as_tensor_labels", [False, True])
def test_heterogeneous_linear_model_matches_jax(as_tensor_labels):
    rng = np.random.default_rng(3)
    labels = np.sort(rng.integers(0, 4, (H, W)), axis=0) * 2 + 3  # labels 3, 5, 7, 9
    signal = rng.uniform(0, 1, (H, W)).astype(np.float32)
    out = {}
    for pkg in (da, dt):
        given_labels = torch.from_numpy(labels) if (pkg is dt and as_tensor_labels) else labels
        model = pkg.HeterogeneousLinearModel(
            given_labels, key="b ", **{"b scaling": [1.0, 1.5, 0.5, 2.0], "b offset": 0.1}
        )
        given = torch.from_numpy(signal) if pkg is dt else signal
        results = [np_of(model(given))]
        model.update(scaling=[0.9, 1.1, 1.3, 0.7])
        results.append(np_of(model(given)))
        model.update_model_parameters(np.arange(8) / 10.0)
        results.append(np_of(model(given)))
        model.update_model_parameters([0.2, 0.4, 0.6, 0.8], dofs=["offset"])
        results.append(np_of(model(given)))
        model.update_model_parameters([2.0, 1.0, 3.0, 4.0], dofs=["scaling"])
        img = pkg.ScalarImage(given, width=1.0, height=1.0)
        results.append(np_of(model(img)))
        out[pkg] = results
    assert out[dt][0].dtype == np.float32
    for port, ref in zip(out[dt], out[da]):
        assert np.abs(port - ref).max() <= 1e-7
    with pytest.raises(ValueError):
        dt.HeterogeneousLinearModel(labels).update_model_parameters([1.0], dofs=["x"])
