"""The port's earth mover's distance (``cv2.EMD``) against the JAX package.

Mirrors ``tests/unit/test_wasserstein.py::test_cv2_emd`` and
``::test_cv2_emd_mass_scaling`` and
``tests/unit/test_api_surface5.py::test_emd_distance_matrix``: the same
images (made from numpy) go through both packages on the CPU.  Both call
OpenCV's exact transport solve on the same float32 signatures, so the
distances agree to 1e-9 relative.  The two pinned values are the JAX
package's on this machine; ``chip_smoke.py`` phase M3 holds the card's run
to them within 1e-6 relative (another OpenCV build there).
"""

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

#: The reference's anchor of the two-squares problem (Beckmann solvers).
TRUE_DISTANCE = 0.379543951823
#: cv2.EMD through the JAX package on the two-squares problem and on the
#: seeded 64x64 pair of :func:`pair64`.
EMD_TWO_SQUARES = 0.3809106647968293
EMD_SEEDED_64 = 0.11485148221254349
#: Both packages solve one LP on equal signatures.
REL_TOL = 1e-9

META = {"width": 1, "height": 1, "space_dim": 2, "scalar": True}


def two_squares() -> tuple:
    """The 10x10 two-squares densities of unit mass."""
    src = np.zeros((10, 10))
    src[2:5, 2:5] = 1
    dst = np.zeros((10, 10))
    dst[1:3, 1:2] = 1
    dst[4:7, 7:9] = 1
    cell = 1.0 / 100
    return src / (src.sum() * cell), dst / (dst.sum() * cell)


def pair64(seed: int = 16, n: int = 160) -> tuple:
    """Two 64x64 densities of unit mass, each on ``n`` seeded pixels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = np.zeros((64, 64))
        a.flat[rng.choice(64 * 64, n, replace=False)] = rng.uniform(0.5, 1.5, n)
        out.append(a / (a.sum() / 64**2))
    return tuple(out)


def _images(pkg, arrays, scale=1.0):
    if pkg is dt:
        return [dt.Image(torch.from_numpy(scale * a), **META) for a in arrays]
    return [da.Image(scale * a, **META) for a in arrays]


@pytest.mark.parametrize("problem,pinned", [(two_squares, EMD_TWO_SQUARES), (pair64, EMD_SEEDED_64)])
def test_cv2_emd(problem, pinned):
    arrays = problem()
    port = dt.wasserstein_distance(*_images(dt, arrays), method="cv2.emd")
    jax = da.wasserstein_distance(*_images(da, arrays), method="cv2.emd")
    assert isinstance(port, float)
    assert port == pytest.approx(jax, rel=REL_TOL)
    assert port == pytest.approx(pinned, rel=REL_TOL)
    if problem is two_squares:
        assert np.isclose(port, TRUE_DISTANCE, rtol=1e-2)


def test_cv2_emd_mass_scaling():
    """EMD scales with the total mass, and agrees with the Newton solver on
    the scaled problem (the JAX test's 3e-2)."""
    arrays = two_squares()
    base = dt.wasserstein_distance(*_images(dt, arrays), method="cv2.emd")
    src, dst = _images(dt, arrays, 5.0)
    scaled = dt.wasserstein_distance(src, dst, method="cv2.emd")
    assert np.isclose(scaled, 5.0 * base, rtol=1e-6)
    jax = da.wasserstein_distance(*_images(da, arrays, 5.0), method="cv2.emd")
    assert scaled == pytest.approx(jax, rel=REL_TOL)
    options = {
        "l1_mode": dt.L1Mode.CONSTANT_CELL_PROJECTION,
        "mobility_mode": dt.MobilityMode.FACE_BASED,
        "num_iter": 400,
        "tol_residual": 1e-3,
        "tol_increment": 1e-3,
        "tol_distance": 1e-3,
        "return_info": True,
        "L": 1e9,
    }
    newton, _ = dt.wasserstein_distance(src, dst, options=options, method="newton")
    assert np.isclose(scaled, newton, rtol=3e-2)


def test_cv2_emd_refuses_a_weight_and_unequal_mass():
    src, dst = _images(dt, two_squares())
    with pytest.raises(AssertionError, match="Weighted"):
        dt.wasserstein_distance(src, dst, method="cv2.emd", weight=src)
    with pytest.raises(ValueError, match="same total mass"):
        dt.EMD()(src, dt.Image(2 * dst.img, **META))


def test_emd_distance_matrix():
    a = np.zeros((12, 12))
    a[2:5, 2:5] = 1.0
    b = np.zeros((12, 12))
    b[7:10, 7:10] = 1.0
    port = dt.EMD().distance_matrix(_images(dt, [a, b, a.copy(), np.roll(b, 1, axis=1)]))
    jax = da.EMD().distance_matrix(_images(da, [a, b, a.copy(), np.roll(b, 1, axis=1)]))
    assert port.shape == (4, 4)
    assert np.array_equal(port, port.T) and np.all(np.diag(port) == 0.0)
    assert port[0, 1] > 0 and port[0, 2] == pytest.approx(0.0, abs=1e-12)
    np.testing.assert_allclose(port, jax, rtol=REL_TOL, atol=0)


def test_emd_preprocess_and_signature():
    """``preprocess`` runs before the solve; the signature is (mass, x, y)
    float32 rows of the nonzero pixels, as the JAX package builds it."""
    src, dst = _images(dt, two_squares())
    jsrc, jdst = _images(da, two_squares())
    flip = lambda img: dt.Image(torch.flip(img.img, dims=[1]), **META)  # noqa: E731
    jflip = lambda img: da.Image(np.asarray(img.img)[:, ::-1].copy(), **META)  # noqa: E731
    port = dt.wasserstein_distance(src, dst, method="cv2.emd", preprocess=flip)
    jax = da.wasserstein_distance(jsrc, jdst, method="cv2.emd", preprocess=jflip)
    assert port == pytest.approx(jax, rel=REL_TOL)
    sig = dt.EMD._img_to_signature(src, normalization=2.0)
    want = da.EMD._img_to_signature(jsrc, normalization=2.0)
    assert sig.dtype == np.float32 and np.array_equal(sig, want)
