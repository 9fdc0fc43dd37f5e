"""The port's skeleton analysis against the JAX package.

The skeleton is computed with boolean tensor ops on the mask's device
(``darsia_tpu_torch/ops/morphology.py``); here, on CPU tensors, it must be
bitwise equal to the JAX package's ``utils/morphology.py::skeletonize`` on
masks with holes, masks touching the border, one-pixel-wide masks and
seeded blobs.  The feature points (endpoints, branch points, leaves,
junctions, base junctions) and the path tracking built on them
(``PathEvolutionAnalysis``: path counts, advance rates, ``tip_advance``)
are equal.  The masks are the JAX tests' (``tests/unit/test_analysis_tools.py``)
and seeded ones, all small.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.utils.morphology import skeletonize as jax_skeletonize
from darsia_tpu_torch.ops.morphology import dilate_cross, erode_cross, neighbour_count, skeletonize

torch.set_num_threads(1)


def _blobs(seed: int, shape=(48, 64), grow: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ndimage.binary_dilation(rng.random(shape) > 0.96, iterations=grow)


def _comb() -> np.ndarray:
    """tests/unit/test_analysis_tools.py's comb: a top bar, a plain tooth
    and a forked one."""
    mask = np.zeros((40, 40), dtype=bool)
    mask[5, 5:35] = True
    mask[5:30, 10] = True
    mask[5:20, 25] = True
    mask[20:30, 22] = True
    mask[20:30, 28] = True
    mask[19, 23:28] = True
    return mask


def _fingers(depths=(12, 18, 9), width: int = 5) -> np.ndarray:
    """A band with fingers hanging from it."""
    mask = np.zeros((48, 64), dtype=bool)
    mask[4:14] = True
    for k, depth in enumerate(depths):
        col = 8 + 20 * k
        mask[14 : 14 + depth, col : col + width] = True
    return mask


def _holes() -> np.ndarray:
    mask = np.zeros((40, 56), dtype=bool)
    mask[3:37, 4:50] = True
    mask[10:20, 10:22] = False
    mask[25:30, 30:45] = False
    mask[18, 40] = False
    return mask


def _border() -> np.ndarray:
    mask = _blobs(3)
    mask[0, :] = True
    mask[:, -1] = True
    mask[-5:, :7] = True
    return mask


def _thin() -> np.ndarray:
    mask = np.zeros((30, 40), dtype=bool)
    mask[5, 2:35] = True
    mask[5:25, 20] = True
    mask[np.arange(10, 28), np.arange(2, 20)] = True
    return mask


MASKS = {
    "holes": _holes,
    "border": _border,
    "one_pixel": _thin,
    "comb": _comb,
    "fingers": _fingers,
    "blobs_0": lambda: _blobs(0),
    "blobs_1": lambda: _blobs(1, grow=5),
    "full": lambda: np.ones((12, 17), dtype=bool),
    "empty": lambda: np.zeros((12, 17), dtype=bool),
    "bar": lambda: np.pad(np.ones((3, 26), bool), ((14, 13), (2, 2))),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_skeleton_bitwise_equal_to_jax(name):
    mask = MASKS[name]()
    got, iterations = skeletonize(torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jax_skeletonize(mask))
    # One iteration per erosion until the mask is empty.
    eroded, count = mask, 0
    while eroded.any():
        eroded = ndimage.binary_erosion(eroded, structure=ndimage.generate_binary_structure(2, 1))
        count += 1
    assert iterations == count


@pytest.mark.parametrize("name", ["holes", "border", "one_pixel", "blobs_0"])
def test_cross_erosion_dilation_and_counts_match_scipy(name):
    mask = MASKS[name]()
    cross = ndimage.generate_binary_structure(2, 1)
    t = torch.from_numpy(mask)
    np.testing.assert_array_equal(erode_cross(t).numpy(), ndimage.binary_erosion(mask, structure=cross))
    np.testing.assert_array_equal(dilate_cross(t).numpy(), ndimage.binary_dilation(mask, structure=cross))
    ones = ndimage.convolve(mask.astype(np.int32), np.ones((3, 3), np.int32), mode="constant")
    np.testing.assert_array_equal(neighbour_count(t).numpy(), ones)


@pytest.mark.parametrize("name", ["comb", "fingers", "holes", "border", "one_pixel", "blobs_1"])
def test_feature_points_equal(name):
    mask = MASKS[name]()
    ref = da.SkeletonAnalysis()
    ref.load(mask)
    port = dt.SkeletonAnalysis(device="cpu")
    port.load(mask)
    assert port.skeleton_mask.device.type == "cpu"
    np.testing.assert_array_equal(port.endpoints(), ref.endpoints())
    np.testing.assert_array_equal(port.branch_points(), ref.branch_points())
    assert port.skeleton_length() == ref.skeleton_length()
    for got, want in zip(port.leaves_and_junctions(), ref.leaves_and_junctions()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
        port.leaves_and_junctions(max_group_distance=3), ref.leaves_and_junctions(max_group_distance=3)
    ):
        np.testing.assert_array_equal(got, want)


def test_load_takes_images_rois_and_fill_holes():
    mask = _holes()
    img_j = da.ScalarImage(mask.astype(np.float32), width=2.0, height=1.5)
    img_t = dt.ScalarImage(torch.from_numpy(mask.astype(np.float32)), width=2.0, height=1.5)
    roi = (slice(2, 38), slice(5, 52))
    for fill in (False, True):
        ref = da.SkeletonAnalysis()
        ref.load(img_j, roi=roi, fill_holes=fill)
        port = dt.SkeletonAnalysis()
        port.load(img_t, roi=roi, fill_holes=fill)
        np.testing.assert_array_equal(port.skeleton_mask.numpy(), ref.skeleton_mask)
        assert port.skeleton_length() == pytest.approx(ref.skeleton_length(), rel=1e-12)


def test_contour_skeleton_equal():
    """``skeleton()``: the main contour filled and skeletonized (OpenCV)."""
    pytest.importorskip("cv2")
    mask = _fingers()
    ref = da.SkeletonAnalysis(reduce_to_main_contour=True)
    ref.load(mask)
    port = dt.SkeletonAnalysis(reduce_to_main_contour=True, device="cpu")
    port.load(mask)
    np.testing.assert_array_equal(port.skeleton().numpy(), ref.skeleton())
    np.testing.assert_array_equal(port.contour, ref.contour)


def test_numpy_mask_goes_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.SkeletonAnalysis().load(_comb())


def _identity_points(pkg):
    evolution = pkg.PathEvolutionAnalysis(**({"device": "cpu"} if pkg is dt else {}))
    evolution.add(np.array([[10, 5], [10, 20]]), time=0.0)
    evolution.add(np.array([[14, 5], [13, 20]]), time=1.0)
    evolution.add(np.array([[18, 5], [15, 12], [16, 20]]), time=2.0)
    evolution.add(np.array([[19, 5], [16, 12]]), time=3.5)
    evolution.find_paths()
    return evolution


def test_path_tracking_equal():
    ref, port = _identity_points(da), _identity_points(dt)
    assert len(port.paths) == len(ref.paths) == 3
    for a, b in zip(port.paths, ref.paths):
        assert [(u.time, u.id) for u in a] == [(u.time, u.id) for u in b]
        np.testing.assert_array_equal([u.position for u in a], [u.position for u in b])
    for t in range(4):
        assert port.path_counts(t) == ref.path_counts(t)
    assert port.advance_rates() == ref.advance_rates()


def test_mask_history_equal():
    """``add_mask``: a finger growing over four masks; tips, skeleton
    lengths, growth and ``tip_advance`` equal."""
    ref, port = da.PathEvolutionAnalysis(), dt.PathEvolutionAnalysis(device="cpu")
    for t, depths in enumerate([(6, 9, 4), (10, 14, 7), (14, 20, 9), (18, 26, 12)]):
        mask = _fingers(depths)
        a = ref.add_mask(mask, time=float(t))
        b = port.add_mask(torch.from_numpy(mask), time=float(t))
        np.testing.assert_array_equal(b["tips"], a["tips"])
        assert {k: v for k, v in b.items() if k != "tips"} == {k: v for k, v in a.items() if k != "tips"}
    np.testing.assert_array_equal(port.tip_advance(), ref.tip_advance())
    port.find_paths()
    ref.find_paths()
    assert port.advance_rates() == ref.advance_rates()
    assert [port.path_counts(t) for t in range(4)] == [ref.path_counts(t) for t in range(4)]
