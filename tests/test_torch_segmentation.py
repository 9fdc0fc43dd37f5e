"""Parity of the port's watershed segmentation and label utilities with the
JAX package, on the CPU.

``segment`` on a seeded layered RGB scene, with supervised and
gradient-based markers, median and TVD smoothing, the rescaling factor 0.5
and the clean-up.  Tolerances: the Scharr edges within 1e-6 relative to
their largest value; the uint16 landscape handed to the watershed within one
level; the labels equal, except where the landscapes differ by a level (a
last-bit difference of the edges can move it and the flooding with it):
such pixels are counted and must stay under 0.1% of the image.  The label
utilities are bitwise equal.
"""

import numpy as np
import pytest
import scipy.ndimage
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 72, 96
MARKERS = [[6, 48], [30, 20], [50, 70], [66, 40]]


def layered_scene(seed=0) -> np.ndarray:
    """Four wavy layers of different colour, with noise and speckle."""
    rng = np.random.default_rng(seed)
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    labels = np.zeros((H, W), dtype=int)
    for k, row in enumerate((18, 40, 58), start=1):
        labels += rows >= row + 3 * np.sin(2 * np.pi * cols / 60.0 + k)
    colours = np.array([[0.8, 0.7, 0.5], [0.5, 0.4, 0.3], [0.3, 0.35, 0.2], [0.6, 0.6, 0.65]])
    img = colours[labels] + rng.normal(0, 0.02, (H, W, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def run_segment(monkeypatch, pkg, img, **kwargs):
    """``segment``'s labels and the landscape it flooded."""
    seen = {}
    flood = scipy.ndimage.watershed_ift

    def recording(landscape, markers, *args, **kw):
        seen["landscape"] = np.array(landscape)
        return flood(landscape, markers, *args, **kw)

    monkeypatch.setattr(scipy.ndimage, "watershed_ift", recording)
    extra = {"device": "cpu"} if pkg is dt else {}
    labels = pkg.segment(img, **extra, **kwargs)
    monkeypatch.setattr(scipy.ndimage, "watershed_ift", flood)
    return np.asarray(labels), seen["landscape"]


CASES = {
    "supervised_scharr_median": dict(
        markers_method="supervised", edges_method="scharr", marker_points=MARKERS,
        **{"median disk radius": 3},
    ),
    "supervised_scharr_rescaled": dict(
        markers_method="supervised", edges_method="scharr", marker_points=[[r // 2, c // 2] for r, c in MARKERS],
        **{"median disk radius": 2, "rescaling factor": 0.5},
    ),
    "gradient_based_median_cleanup": dict(
        **{"median disk radius": 2, "markers disk radius": 2, "gradient disk radius": 1,
           "dilation size": 3, "boundary size": 2}
    ),
    "gradient_based_tvd_value": dict(
        method="tvd", monochromatic_color="value",
        **{"markers disk radius": 1, "threshold": None}
    ),
    "supervised_red_no_cleanup": dict(
        markers_method="supervised", edges_method="scharr", marker_points=MARKERS,
        monochromatic_color="red", cleanup=False, **{"median disk radius": 2}
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segment_matches_jax(monkeypatch, case):
    img = layered_scene()
    kwargs = CASES[case]
    labels_j, land_j = run_segment(monkeypatch, da, img, **kwargs)
    labels_p, land_p = run_segment(monkeypatch, dt, img, **kwargs)
    assert labels_p.dtype == np.int32 and labels_p.shape == (H, W)
    level = np.abs(land_p.astype(np.int64) - land_j.astype(np.int64))
    assert level.max() <= 1
    moved = labels_p != labels_j
    if moved.any():
        assert level.any(), "labels differ on equal landscapes"
    assert moved.sum() < 1e-3 * moved.size, moved.sum()
    assert len(np.unique(labels_p)) >= 2


def test_segment_of_an_image_keeps_its_metadata():
    img = layered_scene(1)
    out = {}
    for pkg in (da, dt):
        kw = {"device": "cpu"} if pkg is dt else {}
        image = pkg.Image(torch.from_numpy(img) if pkg is dt else img, width=2.0, height=1.5)
        labels = pkg.segment(image, markers_method="supervised", edges_method="scharr",
                             marker_points=MARKERS, **{"median disk radius": 2}, **kw)
        assert labels.scalar and labels.dimensions == [1.5, 2.0]
        out[pkg] = np.asarray(labels.img)
    np.testing.assert_array_equal(out[dt], out[da])


@pytest.mark.parametrize("seed", [0, 1])
def test_scharr_edges_match_jax(seed):
    gray = np.random.default_rng(seed).random((H, W)).astype(np.float32)
    ref = np.asarray(da.scharr_edges(gray))
    port = dt.scharr_edges(torch.from_numpy(gray))
    assert port.dtype == np.float32
    assert np.abs(port.astype(np.float64) - ref).max() <= 1e-6 * ref.max()
    # A ramp: the stencil's sign and scale (a true convolution).
    ramp = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    edge = dt.scharr_edges(torch.from_numpy(ramp))
    np.testing.assert_allclose(edge[1:-1, 1:-1], 2.0, rtol=1e-6)
    np.testing.assert_allclose(edge, np.asarray(da.scharr_edges(ramp)), rtol=1e-6)


def test_label_utilities_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, (H, W)) * 3
    sketch = layered_scene(2)
    sketch[:5, :5] = [0.1, 0.9, 0.1]  # a small patch of its own colour
    out = {}
    for pkg in (da, dt):
        results = [
            np.asarray(pkg.group_labels(labels, [[0, 3], [9, 12, 15]])),
            np.asarray(pkg.reassign_labels(labels, {3: 100, 6: 0})),
            np.asarray(pkg.make_consecutive(labels)),
            np.asarray(pkg.label_image(np.round(sketch * 4) / 4)),
            np.asarray(pkg.label_image(np.round(sketch * 4) / 4, significance=0.01)),
            np.asarray(pkg.label_image(labels)),
        ]
        image = pkg.Image(torch.from_numpy(labels) if pkg is dt else labels, scalar=True)
        results.append(np_img(pkg.make_consecutive(image)))
        results.append(np_img(pkg.group_labels(image, [[0, 3]])))
        out[pkg] = results
    for port, ref in zip(out[dt], out[da]):
        np.testing.assert_array_equal(port, ref)


def np_img(image) -> np.ndarray:
    img = image.img
    return img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
