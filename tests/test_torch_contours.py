"""The port's contour analysis and segmentation comparison against the JAX
package.

``contour_length``, ``ContourAnalysis`` (contours, lengths, peaks and
valleys, the main contour, labelled images, ROIs), ``extract_lower_arc``
and ``SegmentationComparison`` (comparison array, overlay, fractions,
overlaps) on small seeded and hand-drawn masks: equal (lengths within
1e-12 relative: both call ``cv2.arcLength`` on the same contour, scaled by
the same voxel size).  The port's masks are CPU tensors.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import darsia_tpu as da
import darsia_tpu_torch as dt

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)


def _fingers() -> np.ndarray:
    mask = np.zeros((48, 80), dtype=bool)
    mask[:14] = True
    for k, depth in enumerate((12, 20, 9, 16)):
        col = 6 + 18 * k
        mask[14 : 14 + depth, col : col + 6] = True
    return mask


def _blobs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ndimage.binary_dilation(rng.random((50, 70)) > 0.97, iterations=3)


def _labels(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ndimage.median_filter(rng.integers(0, 4, (40, 60)), size=7)


MASKS = {"fingers": _fingers, "blobs_0": lambda: _blobs(0), "blobs_1": lambda: _blobs(1)}


def _images(mask: np.ndarray):
    data = mask.astype(np.float32)
    return (
        da.ScalarImage(data, width=2.0, height=1.2),
        dt.ScalarImage(torch.from_numpy(data), width=2.0, height=1.2),
    )


@pytest.mark.parametrize("name", sorted(MASKS))
@pytest.mark.parametrize("fill_holes", [False, True])
def test_contour_length_equal(name, fill_holes):
    mask = MASKS[name]()
    img_j, img_t = _images(mask)
    want, contours_j = da.contour_length(img_j, fill_holes=fill_holes, return_contours=True)
    got, contours_t = dt.contour_length(img_t, fill_holes=fill_holes, return_contours=True)
    assert got == pytest.approx(want, rel=1e-12)
    assert len(contours_t) == len(contours_j)
    for a, b in zip(contours_t, contours_j):
        np.testing.assert_array_equal(a, b)
    # A plain array: lengths in pixels.
    assert dt.contour_length(torch.from_numpy(mask)) == da.contour_length(mask)


@pytest.mark.parametrize("values", [1, [1, 3], True])
def test_contour_length_of_labels(values):
    labels = _labels(2)
    roi = (slice(3, 37), slice(4, 55))
    want = da.contour_length(labels, roi=roi, values_of_interest=values)
    got = dt.contour_length(torch.from_numpy(labels), roi=roi, values_of_interest=values)
    assert got == want


@pytest.mark.parametrize("name", sorted(MASKS))
@pytest.mark.parametrize("main", [False, True])
def test_contour_analysis_equal(name, main):
    mask = MASKS[name]()
    img_j, img_t = _images(mask)
    ref = da.ContourAnalysis(reduce_to_main_contour=main)
    ref.load(img_j, mask=da.ScalarImage(mask, width=2.0, height=1.2))
    port = dt.ContourAnalysis(reduce_to_main_contour=main)
    port.load(img_t, mask=dt.ScalarImage(torch.from_numpy(mask), width=2.0, height=1.2))
    for a, b in zip(port.contours(), ref.contours()):
        np.testing.assert_array_equal(a, b)
    assert port.length() == pytest.approx(ref.length(), rel=1e-12)
    for got, want in zip(port.local_extrema(), ref.local_extrema()):
        np.testing.assert_array_equal(got, want)
    direction = np.array([1.0, 0.5])
    for got, want in zip(
        port.local_extrema(direction, min_distance=3), ref.local_extrema(direction, min_distance=3)
    ):
        np.testing.assert_array_equal(got, want)
    assert (port.number_peaks(), port.number_valleys()) == (ref.number_peaks(), ref.number_valleys())


def test_contour_analysis_labels_and_smoother():
    labels = _labels(5)
    ref = da.ContourAnalysis(contour_smoother=da.MovingAverageSmoother(window=5))
    ref.load_labels(labels, roi=(slice(2, 38), slice(2, 58)), values_of_interest=[0, 2])
    port = dt.ContourAnalysis(contour_smoother=dt.MovingAverageSmoother(window=5))
    port.load_labels(torch.from_numpy(labels), roi=(slice(2, 38), slice(2, 58)), values_of_interest=[0, 2])
    for a, b in zip(port.contours(), ref.contours()):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(port.local_extrema(), ref.local_extrema()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center", [(30, 20), (25, 28), (40, 15)])
def test_extract_lower_arc_equal(center):
    mask = np.zeros((44, 70), dtype=np.uint8)
    cv2.circle(mask, center, 12, 1, -1)
    cv2.rectangle(mask, (center[0] - 4, center[1]), (center[0] + 3, center[1] + 14), 1, -1)
    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    np.testing.assert_array_equal(dt.extract_lower_arc(contours[0]), da.extract_lower_arc(contours[0]))
    short = contours[0][:2]
    np.testing.assert_array_equal(dt.extract_lower_arc(short), da.extract_lower_arc(short))


@pytest.mark.parametrize("n", [2, 3])
def test_segmentation_comparison_equal(n):
    masks = [_blobs(k) for k in range(n)]
    ref = da.SegmentationComparison(n)
    port = dt.SegmentationComparison(n, device="cpu")
    code = port.compare_segmentations_binary_array(*[torch.from_numpy(m) for m in masks])
    np.testing.assert_array_equal(code.numpy(), ref.compare_segmentations_binary_array(*masks))
    rgb = port(*[torch.from_numpy(m) for m in masks])
    rgb_j = ref(*masks)
    np.testing.assert_array_equal(rgb.numpy(), rgb_j)
    assert port.color_fractions(rgb) == ref.color_fractions(rgb_j)
    assert port.get_combinations() == ref.get_combinations()
    assert port.overlap(masks[0], masks[1]) == ref.overlap(masks[0], masks[1])
    empty = np.zeros((4, 4), bool)
    assert port.overlap(empty, empty) == ref.overlap(empty, empty) == 1.0


def test_empty_mask_equal():
    """An empty mask (a region the threshold leaves blank): no contour, no
    extrema, length 0, an empty skeleton with no leaves or junctions, and
    trackers that count no paths, in both packages."""
    mask = np.zeros((40, 60), dtype=bool)
    got_a = dt.ContourAnalysis(reduce_to_main_contour=True)
    got_a.load_labels(mask, fill_holes=False)
    want_a = da.ContourAnalysis(reduce_to_main_contour=True)
    want_a.load_labels(mask, fill_holes=False)
    assert got_a.contours() == want_a.contours() == []
    for got, want in zip(got_a.local_extrema(), want_a.local_extrema()):
        assert got.shape == want.shape == (0, 2)
    assert dt.contour_length(mask) == da.contour_length(mask) == 0.0
    got_s = dt.SkeletonAnalysis()
    got_s.load(torch.from_numpy(mask))
    want_s = da.SkeletonAnalysis()
    want_s.load(mask)
    assert not got_s.skeleton_mask.any()
    for got, want in zip(got_s.leaves_and_junctions(), want_s.leaves_and_junctions()):
        np.testing.assert_array_equal(got, want)
    got_p, want_p = dt.PathEvolutionAnalysis(), da.PathEvolutionAnalysis()
    for t in range(3):
        for tracker in (got_p, want_p):
            tracker.add(np.zeros((0, 2), dtype=int), time=float(t))
            tracker.find_paths(reset=True)
        assert got_p.path_counts(t) == want_p.path_counts(t)
