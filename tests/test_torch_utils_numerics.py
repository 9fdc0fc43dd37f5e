"""The port's numerics utilities against the JAX package.

Slices, sorting, array products, formats and the timing decorator (plain
Python, equal); value and colour detection and ``orthogonal_colors``
(equal voxels); ``hsv_spectrum`` (histogram counts equal but for pixels
whose HSV value lies within 1e-5 of a bin edge, counted); Harris corners
(equal keypoints on a scene without near-ties), patch descriptors within
1e-6, ``match_features`` (on the same features: equal) and
``find_matches`` (the shift within 1e-4 px of JAX's); CG, GMRES and ``KSP`` on assembled matrices (scipy in both: equal)
and on operators given as callables (the port's tensors against JAX's
arrays: solutions within 1e-5 relative).  Small seeded inputs; the port on
CPU tensors.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)


def test_slices_sort_arithmetics_formats():
    a, b = (slice(2, 9), slice(1, 4)), (slice(1, 3), slice(0, 2))
    for name in ("add_slices", "subtract_slices"):
        assert getattr(dt, name)(a[0], b[0]) == getattr(da, name)(a[0], b[0])
    for name in ("add_slice_pairs", "subtract_slice_pairs"):
        assert getattr(dt, name)(a, b) == getattr(da, name)(a, b)
    arr = np.arange(60).reshape(3, 4, 5)
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(dt.array_slice(arr, axis, 1, 3), da.array_slice(arr, axis, 1, 3))
        assert dt.array_slice_argument(arr, axis, 0, 2, 1) == da.array_slice_argument(arr, axis, 0, 2, 1)
    pts = np.random.default_rng(0).permutation(np.array([[0, 0], [10, 1], [11, 12], [1, 13]]))
    np.testing.assert_array_equal(dt.sort_quad(pts), da.sort_quad(pts))
    x, y = np.random.default_rng(1).random((4, 5, 3)), np.random.default_rng(2).random((4, 5))
    np.testing.assert_array_equal(dt.array_product(x, y), da.array_product(x, y))
    np.testing.assert_array_equal(dt.array_product(y, y), da.array_product(y, y))
    with pytest.raises(ValueError):
        dt.array_product(x, np.ones((3, 5)))
    assert [f.value for f in dt.Format] == [f.value for f in da.Format]


def test_timing_decorator_logs(caplog):
    @dt.timing_decorator
    def twice(v):
        return 2 * v

    with caplog.at_level(logging.INFO, logger="darsia_tpu_torch.utils.timings"):
        assert twice(3) == 6
    assert "twice executed in" in caplog.text and twice.__name__ == "twice"


def _scene(seed: int = 0, shape=(40, 56)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full(shape + (3,), 0.3, np.float32)
    img[5:15, 10:30] = [0.8, 0.2, 0.1]
    img[22:35, 35:50] = [0.1, 0.2, 0.9]
    return img + rng.normal(0, 0.002, img.shape).astype(np.float32)


@pytest.mark.parametrize("tolerance", [0.01, 0.05])
def test_detection_equal(tolerance):
    img = _scene()
    got = dt.detect_color(torch.from_numpy(img), [0.8, 0.2, 0.1], tolerance)
    want = da.detect_color(img, [0.8, 0.2, 0.1], tolerance)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(got) > 100
    gray = img[..., 2]
    got = dt.detect_value(dt.ScalarImage(torch.from_numpy(gray), width=1.0, height=1.0), 0.9, tolerance)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(da.detect_value(gray, 0.9, tolerance)))
    pts = np.random.default_rng(3).random((8, 2))
    np.testing.assert_array_equal(dt.detect_closest_point(pts, [0.5, 0.5]), da.detect_closest_point(pts, [0.5, 0.5]))
    for color in ([0.8, 0.2, 0.1], [0.0, 0.0, 1.0], [0.3, 0.3, 0.3]):
        np.testing.assert_array_equal(dt.orthogonal_colors(color), da.orthogonal_colors(color))


def test_detect_color_of_a_uint8_image_with_an_integer_colour():
    """A uint8 photograph against an integer colour, as the crop assistant's
    callers give it: the distance in float64, as numpy's norm takes it."""
    img = (_scene() * 255).astype(np.uint8)
    img[30:33, 2:6] = [255, 0, 255]
    got = dt.detect_color(torch.from_numpy(img), [255, 0, 255], 0.05)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(da.detect_color(img, [255, 0, 255], 0.05)))
    assert len(got) == 12


def test_monochromatic_concentration_analysis_close():
    img = _scene(4)
    want = np.asarray(da.monochromatic_concentration_analysis(da.OpticalImage(img, width=1.0, height=1.0), [0.8, 0.2, 0.1]).img)
    got = dt.monochromatic_concentration_analysis(
        dt.OpticalImage(torch.from_numpy(img), width=1.0, height=1.0), [0.8, 0.2, 0.1]
    )
    assert np.abs(got.img.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("bins", [20, 100])
def test_hsv_spectrum_equal(bins):
    img = _scene(5)
    rois = [None, (slice(0, 20), slice(0, 30)), (slice(20, 40), slice(30, 56))]
    got = dt.hsv_spectrum(torch.from_numpy(img), roi=rois, bins=bins)
    want = da.hsv_spectrum(img, roi=rois, bins=bins)
    hsv = np.asarray(da.ops.color.rgb_to_hsv(jnp.asarray(img)))
    for r, g, w in zip(rois, got, want):
        patch = hsv if r is None else hsv[r]
        for i, key in enumerate(("hue", "saturation", "value")):
            np.testing.assert_array_equal(g[key][1], w[key][1])
            edges = w[key][1]
            near = np.abs(patch[..., i].ravel()[:, None] - edges[None, :]).min(axis=1) <= 1e-5
            assert np.abs(g[key][0] - w[key][0]).sum() <= 2 * int(near.sum())
    # 8-bit input is scaled to [0, 1] in both.
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    got = dt.hsv_spectrum(torch.from_numpy(u8), bins=bins)[0]["value"][0]
    assert got.sum() == u8.shape[0] * u8.shape[1]


def _corner_scene(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros((96, 128), np.float32)
    for _ in range(12):
        r, c = rng.integers(8, 80), rng.integers(8, 110)
        img[r : r + rng.integers(5, 15), c : c + rng.integers(5, 15)] += rng.uniform(0.3, 1)
    return img + rng.normal(0, 0.01, img.shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_harris_and_features_equal(seed):
    gray = _corner_scene(seed)
    np.testing.assert_array_equal(dt.harris_corners(torch.from_numpy(gray)), da.harris_corners(gray))
    np.testing.assert_array_equal(
        dt.harris_corners(torch.from_numpy(gray), max_features=10, k=0.04), da.harris_corners(gray, 10, 0.04)
    )
    rgb = np.stack([gray, 0.5 * gray, 0.2 * gray], axis=-1)
    mask = np.ones(gray.shape, bool)
    mask[:20] = False
    roi = (slice(4, 90), slice(3, 120))
    kp_t, desc_t = dt.FeatureDetection.extract_features(torch.from_numpy(rgb), roi=roi, mask=mask)
    kp_j, desc_j = da.FeatureDetection.extract_features(rgb, roi=roi, mask=mask)
    np.testing.assert_array_equal(kp_t, kp_j)
    assert np.abs(desc_t - desc_j).max() <= 1e-6
    # Matching a shifted copy scores many pairs at a cosine of 1 (ties that
    # the descriptors' last bits order): both packages match the same
    # features here.
    shifted = np.roll(rgb, (2, -3), axis=(0, 1))
    g_src = da.FeatureDetection.extract_features(rgb)
    g_dst = da.FeatureDetection.extract_features(shifted)
    for got, want in zip(
        dt.FeatureDetection.match_features(g_src, g_dst, return_matches=True),
        da.FeatureDetection.match_features(g_src, g_dst, return_matches=True),
    ):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [(3, 5), (-2, 7)])
def test_find_matches_equal(shift):
    rgb = np.stack([_corner_scene(3)] * 3, axis=-1)
    moved = np.roll(rgb, shift, axis=(0, 1))
    mask = np.ones(rgb.shape[:2], bool)
    mask[-6:] = False
    got = dt.FeatureDetection(device="cpu").find_matches(rgb, moved, mask_src=mask)
    want = da.FeatureDetection().find_matches(rgb, moved, mask_src=mask)
    assert got[2] and want[2]
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= 1e-4
    assert np.abs(np.median(got[1] - got[0], axis=0) - np.asarray(shift)).max() <= 0.1


def _tpfa(n: int) -> sps.csr_matrix:
    """The 5-point Laplacian plus a unit mass on an n x n grid."""
    lap = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    eye = sps.eye(n)
    return (sps.kron(lap, eye) + sps.kron(eye, lap) + sps.eye(n * n)).tocsr()


def _nonsymmetric(n: int) -> sps.csr_matrix:
    return (_tpfa(n) + sps.diags([0.4], [1], shape=(n * n, n * n))).tocsr()


@pytest.mark.parametrize("solver", ["cg", "gmres"])
@pytest.mark.parametrize("dense", [False, True])
def test_krylov_on_matrices_equal(solver, dense):
    A = _tpfa(8) if solver == "cg" else _nonsymmetric(8)
    A = A.toarray() if dense else A
    b = np.random.default_rng(6).normal(size=64)
    got = getattr(dt, f"linalg_{solver}")(A, b, tol=1e-10)
    want = getattr(da, f"linalg_{solver}")(A, b, tol=1e-10)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 0
    for cls in ("CG", "GMRES"):
        port = getattr(dt.linalg, cls)(A)
        ref = getattr(da.linalg, cls)(A)
        np.testing.assert_array_equal(port.solve(b, rtol=1e-9), ref.solve(b, rtol=1e-9))


@pytest.mark.parametrize("solver", ["cg", "gmres"])
@pytest.mark.parametrize("n", [6, 12])
def test_krylov_on_operators_close(solver, n):
    A = _tpfa(n) if solver == "cg" else _nonsymmetric(n)
    dense = torch.from_numpy(A.toarray())
    b = np.random.default_rng(n).normal(size=n * n)
    got, info = getattr(dt, f"linalg_{solver}")(lambda v: dense @ v, torch.from_numpy(b), tol=1e-9)
    want, _ = getattr(da, f"linalg_{solver}")(lambda v: jnp.asarray(A.toarray(), jnp.float32) @ v, b, tol=1e-7)
    exact = sps.linalg.spsolve(A.tocsc(), b)
    assert info == 0 and got.dtype == np.float64
    assert np.linalg.norm(got - exact) <= 1e-5 * np.linalg.norm(exact)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    x0 = torch.from_numpy(exact + 0.01)
    warm, _ = getattr(dt, f"linalg_{solver}")(lambda v: dense @ v, torch.from_numpy(b), x0=x0, tol=1e-9)
    assert np.linalg.norm(warm - exact) <= 1e-5 * np.linalg.norm(exact)


@pytest.mark.parametrize("ksp_type", ["preonly", "cg", "gmres"])
def test_ksp_equal(ksp_type):
    A = _tpfa(7)
    b = np.random.default_rng(7).normal(size=49)
    port = dt.KSP(A, nullspace=[np.ones(49)])
    ref = da.KSP(A, nullspace=[np.ones(49)])
    for solver in (port, ref):
        solver.setup({"ksp": {"type": ksp_type, "rtol": 1e-10}})
    np.testing.assert_array_equal(port.solve(b), ref.solve(b))
    port.kill()
    assert port._lu is None
