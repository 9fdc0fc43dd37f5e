"""Parity of the port's balancing and model calibrations with the JAX
package, on the CPU.

``ContinuityBasedBalancingCalibrationMixin``: the label dilation equals
``scipy.ndimage.binary_dilation(..., iterations=w)`` (its cross-shaped
structure) exactly, and the calibrated scalings agree within 1e-5 relative
(the strip means: float64 sums here, numpy's float32 means there).  The
model calibration (injection rate, ``tests/unit/test_analysis_tools.py``'s
scene, and absolute volume) agrees within 1e-4 relative; the line fits are
the same host code and agree exactly.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.analysis import model_calibration as jax_fits
from darsia_tpu_torch.analysis import model_calibration as port_fits
from darsia_tpu_torch.ops.morphology import dilate_cross

torch.set_num_threads(1)


def image(pkg, arr, **meta):
    data = torch.from_numpy(arr) if pkg is dt else arr
    return pkg.OpticalImage(data, width=1.0, height=1.0, **meta)


@pytest.mark.parametrize("width", [1, 3])
def test_dilation_equals_scipy(width):
    rng = np.random.default_rng(width)
    masks = rng.random((3, 30, 40)) < 0.02
    masks[0, 0, :] = True  # touching the border
    out = dilate_cross(torch.from_numpy(masks), width).numpy()
    for m, o in zip(masks, out):
        np.testing.assert_array_equal(o, ndimage.binary_dilation(m, iterations=width))


def balancing_analysis(pkg, base_arr, labels):
    class Balanced(pkg.ConcentrationAnalysis, pkg.ContinuityBasedBalancingCalibrationMixin):
        pass

    return Balanced(
        base=image(pkg, base_arr),
        signal_reduction=pkg.MonochromaticReduction(color="red"),
        balancing=pkg.HeterogeneousLinearModel(labels, scaling=1.0, offset=0.0),
    )


def test_balancing_continuity_scene_matches_jax():
    """tests/unit/test_analysis_tools.py's two-label jump by 2x."""
    labels = np.zeros((20, 20), dtype=int)
    labels[:, 10:] = 1
    arr = np.zeros((20, 20, 3), dtype=np.float32)
    arr[:, :10, 0] = 0.2
    arr[:, 10:, 0] = 0.4
    out = {}
    for pkg in (da, dt):
        analysis = balancing_analysis(pkg, np.zeros((20, 20, 3), np.float32), labels)
        assert analysis.calibrate_balancing([image(pkg, arr, time=1.0)], {"labels": labels})
        out[pkg] = np.asarray(analysis.balancing._scaling, dtype=float)
    np.testing.assert_allclose(out[dt], out[da], rtol=1e-5)
    assert np.isclose(out[dt][1] / out[dt][0], 0.5, rtol=1e-6)


@pytest.mark.parametrize("width", [2, 3])
def test_balancing_many_labels_matches_jax(width):
    """Five wavy layers (one not touching the first) with their own contrast
    on two noisy photographs; labels given as an Image in the port."""
    H, W = 50, 70
    rng = np.random.default_rng(width)
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    labels = np.zeros((H, W), dtype=int)
    for k, row in enumerate((10, 20, 30, 40), start=1):
        labels += rows >= row + 2 * np.sin(2 * np.pi * cols / 35.0 + k)
    gains = np.array([1.0, 0.8, 1.25, 0.6, 1.5])
    base = rng.uniform(0.1, 0.2, (H, W, 3)).astype(np.float32)
    photos = []
    for t in range(2):
        arr = base.copy()
        arr[..., 0] += (0.3 + 0.1 * t) * gains[labels] * (1 + rng.normal(0, 0.05, (H, W)))
        photos.append(arr.astype(np.float32))
    out = {}
    for pkg in (da, dt):
        analysis = balancing_analysis(pkg, base, labels)
        given = dt.Image(torch.from_numpy(labels), scalar=True) if pkg is dt else labels
        options = {"labels": given, "boundary_width": width, "balancing_dofs": ["scaling"]}
        analysis.calibrate_balancing([image(pkg, p, time=float(k)) for k, p in enumerate(photos)], options)
        out[pkg] = np.asarray(analysis.balancing._scaling, dtype=float)
        balanced = analysis._balance_signal(analysis._reduce_signal(analysis._subtract_background(image(pkg, photos[0]))))
        out[pkg, "map"] = np.asarray(balanced)
    np.testing.assert_allclose(out[dt], out[da], rtol=1e-5)
    np.testing.assert_allclose(out[dt] * gains, gains[0], rtol=0.1)  # the contrast undone
    assert np.abs(out[dt, "map"] - out[da, "map"]).max() <= 1e-5


def injection_analysis(pkg):
    class Calibrable(pkg.ConcentrationAnalysis, pkg.InjectionRateModelObjectiveMixin):
        pass

    return Calibrable(
        base=image(pkg, np.zeros((20, 20, 3), dtype=np.float32)),
        signal_reduction=pkg.MonochromaticReduction(color="red"),
        model=pkg.ScalingModel(scaling=1.0),
        **{"restoration -> model": True},
    )


def growing_blob(pkg):
    images = []
    for t in range(1, 4):
        arr = np.zeros((20, 20, 3), dtype=np.float32)
        arr[:, : 4 * t, 0] = 0.5
        images.append(image(pkg, arr, time=float(t)))
    return images


@pytest.mark.parametrize("regression", ["linear", "ransac"])
def test_injection_rate_calibration_matches_jax(regression):
    """tests/unit/test_analysis_tools.py:126-160: the calibrated scaling is 2."""
    out = {}
    for pkg in (da, dt):
        analysis = injection_analysis(pkg)
        geometry = pkg.Geometry(space_dim=2, num_voxels=(20, 20), dimensions=[1, 1])
        analysis.calibrate_model(
            growing_blob(pkg),
            options={
                "initial_guess": np.array([1.0]),
                "injection_rate": 0.2,
                "geometry": geometry,
                "regression_type": regression,
                "method": "Nelder-Mead",
                "maxiter": 200,
                "dofs": ["scaling"],
            },
        )
        out[pkg] = (float(analysis.model._scaling), analysis.model_calibration_postanalysis())
    np.testing.assert_allclose(out[dt][0], out[da][0], rtol=1e-4)
    assert np.isclose(out[dt][0], 2.0, rtol=1e-2)
    assert abs(out[dt][1] - out[da][1]) <= 1e-4


def test_absolute_volume_calibration_matches_jax():
    out = {}
    for pkg in (da, dt):

        class Calibrable(pkg.ConcentrationAnalysis, pkg.AbsoluteVolumeModelObjectiveMixin):
            pass

        analysis = Calibrable(
            base=image(pkg, np.zeros((20, 20, 3), dtype=np.float32)),
            signal_reduction=pkg.MonochromaticReduction(color="red"),
            model=pkg.ScalingModel(scaling=1.0),
            **{"restoration -> model": True},
        )
        geometry = pkg.Geometry(space_dim=2, num_voxels=(20, 20), dimensions=[1e-2, 1e-2])
        # Measured volumes (ml) of a blob 0.5 * (4t / 20) of 1e-4 m^2 at scaling 3.
        times = np.array([1.0, 1.5, 2.0, 2.5, 3.0])
        volumes = 3 * 0.5 * (4 * times / 20) * 1e-4 * 1e6
        analysis.calibrate_model(
            growing_blob(pkg),
            options={
                "initial_guess": np.array([1.0]),
                "geometry": geometry,
                "times": times,
                "volumes": volumes,
                "time_interval": [1.0, 3.0],
                "method": "Nelder-Mead",
                "maxiter": 100,
                "dofs": ["scaling"],
            },
        )
        out[pkg] = float(analysis.model._scaling)
    np.testing.assert_allclose(out[dt], out[da], rtol=1e-4)
    assert np.isclose(out[dt], 3.0, rtol=1e-2)


def test_line_fits_are_the_same_host_code():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 12)
    v = 0.3 * t + 1 + rng.normal(0, 0.05, 12)
    v[3] += 5  # an outlier
    assert port_fits._linear_fit(t, v) == jax_fits._linear_fit(t, v)
    assert port_fits._ransac_fit(t, v) == jax_fits._ransac_fit(t, v)
    assert abs(port_fits._ransac_fit(t, v)[0] - 0.3) < 0.05
