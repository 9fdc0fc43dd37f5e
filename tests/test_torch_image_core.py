"""The port's image core, colour conversions and resize against the JAX package.

Same numpy inputs to both packages, on the CPU.  Host-side metadata
(coordinates, dimensions, origins, times) must match exactly or to float
rounding; tensor results to float32 rounding of elementwise ops (1e-6 on
values in [0, 1]; 1e-4 on LAB's [0, 100] and HSV's [0, 360) scales, where
cbrt/pow and fmod round differently in the two libraries).
"""

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.ops import color as jax_color
from darsia_tpu.ops.resize import resize_array as jax_resize_array
from darsia_tpu_torch.ops import color
from darsia_tpu_torch.ops.resize import resize_array

torch.set_num_threads(1)

META = {"width": 2.8, "height": 1.5}


def _rgb(shape=(24, 40), seed=0):
    return np.random.default_rng(seed).random(shape + (3,)).astype(np.float32)


def _pair(arr, cls="OpticalImage", **meta):
    meta = {**META, **meta}
    return getattr(da, cls)(jnp.asarray(arr), **meta), getattr(dt, cls)(torch.from_numpy(arr), **meta)


def _same_meta(t, j):
    assert t.shape == tuple(j.shape)
    assert np.allclose(t.dimensions, j.dimensions, rtol=0, atol=1e-12)
    assert np.allclose(t.origin, np.asarray(j.origin), rtol=0, atol=1e-12)
    assert t.series == j.series and t.scalar == j.scalar


# ------------------------------------------------------- coordinate system


def test_coordinatesystem_against_jax():
    j, t = _pair(_rgb())
    cs_j, cs_t = j.coordinatesystem, t.coordinatesystem
    vox = np.array([[0, 0], [3, 7], [23, 39], [10, 2]])
    assert np.allclose(cs_t.coordinate(vox), cs_j.coordinate(vox), rtol=0, atol=1e-12)
    assert isinstance(cs_t.coordinate(vox), dt.CoordinateArray)
    assert isinstance(cs_t.coordinate([3, 7]), dt.Coordinate)
    pts = np.array([[0.1, 1.4], [2.79, 0.01], [1.0, 0.75]])
    assert np.array_equal(cs_t.voxel(pts), cs_j.voxel(pts))
    assert isinstance(cs_t.voxel(pts), dt.VoxelArray)
    assert isinstance(cs_t.voxel([1.0, 0.75]), dt.Voxel)
    assert np.array_equal(cs_t.voxels, cs_j.voxels)
    assert np.allclose(cs_t.coordinates, cs_j.coordinates, rtol=0, atol=1e-12)
    assert cs_t.length(5, "x") == cs_j.length(5, "x")
    assert cs_t.num_voxels(0.3, "y") == cs_j.num_voxels(0.3, "y")
    assert cs_t == t.coordinatesystem
    assert cs_t != dt.OpticalImage(torch.from_numpy(_rgb((24, 41))), **META).coordinatesystem


def test_point_types_against_jax():
    for make in ("make_coordinate", "make_voxel"):
        for pts in ([1.7, 2.2], [[1.7, 2.2], [3.1, 0.4]]):
            got, want = getattr(dt, make)(pts), getattr(da, make)(pts)
            assert type(got).__name__ == type(want).__name__
            assert np.array_equal(got, want)
    arr = dt.make_voxel([[1, 2], [3, 4]])
    assert isinstance(arr[0], dt.Voxel)
    assert np.array_equal(dt.make_voxel([2.9, 1.1], matrix_indexing=False), [1, 2])


# --------------------------------------------------------------- subregion


@pytest.mark.parametrize("kind", ["tuple", "voxels", "coordinates"])
def test_subregion_against_jax(kind):
    j, t = _pair(_rgb())
    if kind == "tuple":
        roi_j = roi_t = (slice(3, 17), slice(None, 30))
    elif kind == "voxels":
        roi_j = da.make_voxel([[2, 5], [20, 33]])
        roi_t = dt.make_voxel([[2, 5], [20, 33]])
    else:
        pts = [[0.4, 1.2], [2.1, 0.3]]
        roi_j, roi_t = da.make_coordinate(pts), dt.make_coordinate(pts)
    sub_j, sub_t = j.subregion(roi_j), t.subregion(roi_t)
    _same_meta(sub_t, sub_j)
    assert np.array_equal(sub_t.img.numpy(), np.asarray(sub_j.img))
    assert sub_t.color_space == "RGB"


# -------------------------------------------------------------------- time


def _series_pair(T=3, scalar=False):
    rng = np.random.default_rng(1)
    shape = (16, 20, T) if scalar else (16, 20, T, 3)
    arr = rng.random(shape).astype(np.float32)
    dates = [datetime(2024, 1, 1) + timedelta(seconds=30 * k) for k in range(T)]
    cls = "ScalarImage" if scalar else "OpticalImage"
    return _pair(arr, cls, series=True, date=dates)


@pytest.mark.parametrize("scalar", [False, True])
def test_append_and_time_interval_against_jax(scalar):
    j, t = _series_pair(scalar=scalar)
    frame_j, frame_t = j.time_slice(1), t.time_slice(1)
    frame_j.time, frame_t.time = 5.0, 5.0
    j.append(frame_j, offset=100.0)
    t.append(frame_t, offset=100.0)
    _same_meta(t, j)
    assert np.array_equal(t.img.numpy(), np.asarray(j.img))
    assert t.time == j.time and t.date == j.date and t.time_num == j.time_num == 4

    # Appending a frame to a frame makes a series; the tensors are not aliased.
    a_j, a_t = _pair(np.zeros((16, 20, 3), np.float32), time=0.0)
    b_j, b_t = _pair(np.ones((16, 20, 3), np.float32), time=1.0)
    a_j.append(b_j, offset=2.0)
    keep = b_t.img
    a_t.append(b_t, offset=2.0)
    assert a_t.series and a_t.time == a_j.time == [0.0, 3.0]
    assert np.array_equal(a_t.img.numpy(), np.asarray(a_j.img))
    a_t.img[..., 1, :] += 1
    assert torch.equal(keep, torch.ones_like(keep))

    sub_j, sub_t = j.time_interval(slice(1, 3)), t.time_interval(slice(1, 3))
    _same_meta(sub_t, sub_j)
    assert np.array_equal(sub_t.img.numpy(), np.asarray(sub_j.img))
    assert sub_t.time == sub_j.time and sub_t.date == sub_j.date
    with pytest.raises(ValueError):
        t.time_interval(1)


def test_append_refuses_other_grids():
    _, t = _pair(_rgb())
    _, other = _pair(_rgb((24, 41)))
    with pytest.raises(ValueError):
        t.append(other)


# ---------------------------------------------------------- metadata, data


def test_metadata_helpers_against_jax():
    j, t = _pair(_rgb())
    sm_j, sm_t = j.shape_metadata(), t.shape_metadata()
    assert set(sm_t) == set(sm_j)
    for key in ("space_dim", "indexing", "dimensions", "shape", "num_voxels", "voxel_size"):
        assert list(np.ravel(sm_t[key])) == list(np.ravel(sm_j[key])), key
    u8_j, u8_t = j.astype(np.uint8), t.astype(torch.uint8)
    assert np.array_equal(u8_t.img.numpy(), np.asarray(u8_j.img))
    t.update_metadata({"name": "probe"}, time=4.0)
    assert t.name == "probe" and t.time == 4.0


def test_arithmetic_against_jax():
    a_j, a_t = _pair(_rgb(seed=2))
    b_j, b_t = _pair(_rgb(seed=3))
    cases = [
        (lambda a, b: a + b), (lambda a, b: a - b), (lambda a, b: a * b),
        (lambda a, b: a / 2.0), (lambda a, b: 3.0 * a), (lambda a, b: -a),
        (lambda a, b: a + 0.25), (lambda a, b: sum([a, b])),
    ]
    keep = a_t.img.clone()
    for op in cases:
        got, want = op(a_t, b_t), op(a_j, b_j)
        assert type(got) is dt.OpticalImage
        _same_meta(got, want)
        assert np.abs(got.img.numpy() - np.asarray(want.img)).max() <= 1e-6
        assert got.img.data_ptr() not in (a_t.img.data_ptr(), b_t.img.data_ptr())
    assert torch.equal(a_t.img, keep)
    _, other = _pair(_rgb((24, 41)))
    with pytest.raises(ValueError):
        a_t + other


# ------------------------------------------------------------------ colour


_SPACES = ["RGB", "BGR", "HSV", "HLS", "LAB"]
_KEYS = ["gray", "red", "green", "blue", "hue", "saturation", "value", "norm"]


def _color_tol(space):
    return {"HSV": 1e-4, "HLS": 1e-4, "LAB": 1e-4}.get(space, 1e-6)


@pytest.mark.parametrize("target", _SPACES)
def test_to_trichromatic_against_jax(target):
    rgb = _rgb()
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]  # grays, a pure hue
    j, t = _pair(rgb)
    got = t.to_trichromatic(target, return_image=True)
    want = j.to_trichromatic(target, return_image=True)
    assert got.color_space == target
    assert np.abs(got.img.numpy() - np.asarray(want.img)).max() <= _color_tol(target)
    t.to_trichromatic(target)
    assert t.color_space == target
    if target in ("HSV", "LAB", "BGR"):  # these convert back to RGB
        back = t.to_trichromatic("RGB", return_image=True).img.numpy()
        assert np.abs(back - rgb).max() <= 1e-4


@pytest.mark.parametrize("source", ["RGB", "HSV", "LAB", "BGR"])
@pytest.mark.parametrize("key", _KEYS)
def test_to_monochromatic_against_jax(source, key):
    rgb = _rgb()
    j, t = _pair(rgb)
    j.to_trichromatic(source)
    t.to_trichromatic(source)
    mono_t, mono_j = t.to_monochromatic(key), j.to_monochromatic(key)
    assert isinstance(mono_t, dt.ScalarImage) and mono_t.name == key
    _same_meta(mono_t, mono_j)
    tol = 1e-3 if key == "hue" else 1e-4 if source != "RGB" else 1e-6
    assert np.abs(mono_t.img.numpy() - np.asarray(mono_j.img)).max() <= tol


@pytest.mark.parametrize("fn", ["rgb_to_hsv", "rgb_to_hls", "rgb_to_lab"])
def test_uint8_color_inputs_against_jax(fn):
    """Integer images map to [0, 1] first, in both packages."""
    arr = (np.random.default_rng(4).random((8, 9, 3)) * 255).astype(np.uint8)
    got = getattr(color, fn)(torch.from_numpy(arr)).numpy()
    want = np.asarray(getattr(jax_color, fn)(jnp.asarray(arr)))
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize(
    "color_key", ["gray", "red", "green", "blue", "red+green", "negative-key", "hsv", ""]
)
def test_monochromatic_reduction_against_jax(color_key):
    rgb = _rgb()
    kw = {"color": color_key}
    if color_key == "hsv":
        kw.update({"hue lower bound": 0.1, "hue upper bound": 0.8, "saturation lower bound": 0.2})
    got = dt.MonochromaticReduction(**kw)(torch.from_numpy(rgb)).numpy()
    want = np.asarray(da.MonochromaticReduction(**kw)(jnp.asarray(rgb)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    assert np.array_equal(
        dt.MonochromaticReduction(color=lambda x: x[..., 1])(torch.from_numpy(rgb)).numpy(), rgb[..., 1]
    )


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize(
    "shape,target,interpolation,conservative",
    [
        ((48, 64), (12, 16), "inter_area", False),  # integer factors: block mean
        ((48, 64), (12, 16), "inter_area", True),
        ((48, 64), (20, 27), "inter_area", False),  # antialiased triangle
        ((48, 64), (20, 27), "inter_linear", True),
        ((20, 27), (48, 64), "inter_linear", False),  # upsampling
        ((48, 64), (30, 90), "inter_linear", False),  # one axis down, one up
        ((48, 64), (20, 27), "inter_nearest", False),
        ((20, 27), (48, 64), "inter_nearest", False),
        ((48, 64), (20, 27), "cubic", False),
        ((20, 27), (48, 64), "cubic", False),
    ],
)
def test_resize_array_against_jax(shape, target, interpolation, conservative):
    data = np.random.default_rng(5).random(shape + (3,)).astype(np.float32)
    got = resize_array(torch.from_numpy(data), target, interpolation, conservative)
    want = np.asarray(jax_resize_array(jnp.asarray(data), target, interpolation, conservative))
    assert got.shape == want.shape == target + (3,)
    scale = np.prod(shape) / np.prod(target) if conservative else 1.0
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(1.0, scale)


@pytest.mark.parametrize("kw", [{"fx": 0.5, "fy": 0.25}, {"shape": (20, 27)}, {"fx": 1.7, "fy": 1.3, "interpolation": "inter_linear"}])
def test_resize_image_against_jax(kw):
    data = (np.random.default_rng(6).random((48, 64, 3)) * 255).astype(np.uint8)
    j, t = _pair(data)
    got, want = dt.Resize(**kw)(t), da.Resize(**kw)(j)
    _same_meta(got, want)
    assert got.img.dtype == torch.uint8
    # Rounded uint8: a float32 rounding difference flips at most one level.
    assert np.abs(got.img.numpy().astype(int) - np.asarray(want.img).astype(int)).max() <= 1
    assert torch.equal(dt.resize(t, **kw).img, got.img)
    plain = dt.Resize(**kw)(t.img)
    assert torch.equal(plain, got.img)
    ref = dt.Resize(ref_image=got, interpolation="inter_linear")(t)
    assert ref.shape == got.shape
    with pytest.raises(NotImplementedError):
        dt.Resize(interpolation="inter_lanczos")
