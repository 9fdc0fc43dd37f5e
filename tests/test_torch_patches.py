"""The port's ``Patches``, ``PiecewisePerspectiveTransform`` and image
arithmetics against the JAX package.

The same numpy inputs, made from a seed, go through both packages on the
CPU, where both warp with the exact gather.  Tolerances: patch geometry and
host point maps exact; assembled float32 data <= 1e-6; ``find_and_warp``
against a float64 spline's warp <= 1e-5, and against the JAX package only
within the error of its float32 interpolant (measured here, as in
``test_torch_registration.py::test_rbf_interpolate_against_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_registration import _jax_rbf_error, _tps64

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.analysis.translationanalysis import patch_centers
from darsia_tpu_torch.ops.warp import identity_grid, warp

torch.set_num_threads(1)

H, W = 96, 128
META = {"width": 1.28, "height": 0.96}
#: Sums and products of a few float32 values of order 1.
DATA_TOL = 1e-6


def _smooth(seed=0, channels=3, shape=(H, W)):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]), indexing="ij")
    chans = [
        0.5 + 0.4 * np.sin(2 * np.pi * (2 * rng.random() * xx + 2 * rng.random() * yy) + k)
        for k in range(max(channels, 1))
    ]
    data = np.stack(chans, axis=-1).astype(np.float32)
    return data if channels else data[..., 0]


def _pair(data, cls="OpticalImage", **meta):
    meta = {**META, **meta}
    if data.ndim == 2:
        cls = "ScalarImage"
    return getattr(da, cls)(jnp.asarray(data), **meta), getattr(dt, cls)(data, device="cpu", **meta)


# ------------------------------------------------------------------ patches


@pytest.mark.parametrize("num_patches,overlap", [([3, 4], 0.0), ([3, 4], 0.2), (2, 0.1), ([5, 7], 0.3)])
def test_patches_geometry_against_jax(num_patches, overlap):
    jimg, timg = _pair(_smooth())
    jp = da.Patches(jimg, num_patches, rel_overlap=overlap)
    tp = dt.Patches(timg, num_patches, rel_overlap=overlap)
    assert tp.num_patches == jp.num_patches
    assert tp.rois == jp.rois and tp.rois_without_overlap == jp.rois_without_overlap
    assert np.array_equal(tp.centers_voxels, jp.centers_voxels)
    assert np.abs(tp.centers_cartesian - jp.centers_cartesian).max() <= 1e-12
    # The registration's own patch centers are the same points.
    assert np.array_equal(
        patch_centers((H, W), tp.num_patches), tp.centers_voxels.reshape(-1, 2)
    )
    for i in range(tp.num_patches[0]):
        for j in range(tp.num_patches[1]):
            assert tp.position(i, j) == jp.position(i, j)
            t_patch, j_patch = tp(i, j), jp(i, j)
            assert np.array_equal(t_patch.img.numpy(), np.asarray(j_patch.img))
            assert t_patch.dimensions == pytest.approx(j_patch.dimensions, abs=1e-12)
            assert np.abs(np.asarray(t_patch.origin) - np.asarray(j_patch.origin)).max() <= 1e-12
    assert tp(0, 0) is tp(0, 0)


def test_patches_refuse_series():
    series = np.stack([_smooth(), _smooth(1)], axis=2)
    timg = dt.OpticalImage(series, series=True, time=[0.0, 1.0], device="cpu", **META)
    with pytest.raises(NotImplementedError):
        dt.Patches(timg, 2)


@pytest.mark.parametrize("channels", [3, 0])
@pytest.mark.parametrize("overlap", [0.0, 0.25])
def test_assemble_and_blend_against_jax(channels, overlap):
    data = _smooth(2, channels)
    jimg, timg = _pair(data)
    jp = da.Patches(jimg, [3, 4], rel_overlap=overlap)
    tp = dt.Patches(timg, [3, 4], rel_overlap=overlap)
    # Untouched patches give the base back.
    for method in ("assemble", "blend_and_assemble"):
        t_out, j_out = getattr(tp, method)(), getattr(jp, method)()
        assert type(t_out) is type(timg) and t_out.img.dtype == torch.float32
        assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= DATA_TOL
        assert np.abs(t_out.img.numpy() - data).max() <= DATA_TOL
    # Patches replaced (one scaled, one set from numpy), then both ways.
    rng = np.random.default_rng(3)
    for i, j in ((0, 1), (2, 3), (1, 1)):
        new = rng.random(tuple(tp(i, j).img.shape)).astype(np.float32)
        tp.set_image(new, i, j)
        jp.set_image(new, i, j)
    for method in ("assemble", "blend_and_assemble"):
        t_out, j_out = getattr(tp, method)(), getattr(jp, method)()
        assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= DATA_TOL
    # update_img replaces the base.
    out = tp.blend_and_assemble(update_img=True)
    assert tp.base is out


# ------------------------------------------------------ piecewise perspective


def _patch_displacement(tp, amplitude=3.0):
    """A smooth displacement (x, y) at the patch centers, at most
    ``amplitude`` px."""
    c = tp.centers_voxels
    dx = amplitude * np.sin(np.pi * c[..., 1] / W) * np.cos(np.pi * c[..., 0] / H)
    dy = -0.8 * amplitude * np.sin(np.pi * c[..., 0] / H)
    return np.stack([dx, dy], axis=-1)


@pytest.mark.parametrize("reverse", [False, True])
def test_find_and_warp_against_jax_and_a_float64_spline(reverse):
    data = _smooth(4)
    jimg, timg = _pair(data)
    jp, tp = da.Patches(jimg, [3, 4]), dt.Patches(timg, [3, 4])
    disp = _patch_displacement(tp)
    t_trafo = dt.PiecewisePerspectiveTransform()
    t_out = t_trafo.find_and_warp(tp, disp, reverse=reverse)
    assert t_trafo.have_transform and type(t_out) is type(timg)
    assert t_out.img.shape == data.shape and t_out.img.dtype == torch.float32

    # The same warp with the field of a float64 spline at pixel scale.
    centers = tp.centers_voxels.reshape(-1, 2)
    pts = np.stack([centers[:, 1], centers[:, 0]], axis=1)
    rows, cols = np.meshgrid(np.arange(H, dtype=float), np.arange(W, dtype=float), indexing="ij")
    query = np.stack([cols.ravel(), rows.ravel()], axis=1)
    flat = (-disp if reverse else disp).reshape(-1, 2)
    dx = _tps64(pts, flat[:, 0], query).reshape(H, W)
    dy = _tps64(pts, flat[:, 1], query).reshape(H, W)
    field = torch.from_numpy(np.stack([dy, dx]).astype(np.float32))
    ref = warp(torch.from_numpy(data), identity_grid((H, W), "cpu") - field, order=1)
    assert np.abs(t_out.img.numpy() - ref.numpy()).max() <= 1e-5

    # JAX's float32 interpolant is off by its own error (in px); the image
    # changes by at most its steepest slope times that.
    j_out = np.asarray(da.PiecewisePerspectiveTransform().find_and_warp(jp, disp, reverse=reverse).img)
    jax_px = max(_jax_rbf_error(pts, flat[:, k], query) for k in range(2))
    assert jax_px <= 1e-3
    slope = max(np.abs(np.diff(data, axis=0)).max(), np.abs(np.diff(data, axis=1)).max())
    differ = np.abs(t_out.img.numpy() - j_out)
    # The border: a sample within the interpolant's error of the edge falls
    # on either side of the ``mode="constant"`` mask.
    assert differ[2:-2, 2:-2].max() <= 2 * slope * jax_px + 1e-5
    assert (differ > 2 * slope * jax_px + 1e-5).mean() <= 0.01


def test_find_and_warp_uint8_and_few_patches_against_jax():
    data = (_smooth(5) * 255).astype(np.uint8)
    jimg, timg = _pair(data)
    # Two patches: below three points both packages shift by the mean.
    jp, tp = da.Patches(jimg, [1, 2]), dt.Patches(timg, [1, 2])
    disp = np.array([[[2.0, -1.0], [3.0, 0.5]]])
    t_out = dt.PiecewisePerspectiveTransform().find_and_warp(tp, disp)
    j_out = da.PiecewisePerspectiveTransform().find_and_warp(jp, disp)
    assert t_out.img.dtype == torch.uint8
    assert np.array_equal(t_out.img.numpy(), np.asarray(j_out.img))


# -------------------------------------------------------------- arithmetics


def test_weight_against_jax():
    data = _smooth(6)
    jimg, timg = _pair(data)
    for w in (2, 0.5, np.float32(1.5)):
        assert np.abs(dt.weight(timg, w).img.numpy() - np.asarray(da.weight(jimg, w).img)).max() <= DATA_TOL
    # By an image on the same grid, on a coarser grid (resized), scalar.
    for shape in ((H, W), (24, 32)):
        jw, tw = _pair(_smooth(7, 0, shape))
        t_out, j_out = dt.weight(timg, tw), da.weight(jimg, jw)
        assert t_out.img.shape == data.shape
        assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= 1e-5
    # Per channel.
    per_channel = np.array([0.5, 1.0, 2.0])
    t_out, j_out = dt.weight(timg, per_channel), da.weight(jimg, per_channel)
    assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= DATA_TOL
    with pytest.raises(ValueError):
        dt.weight(timg, np.ones(5))
    # The operand is left alone.
    assert np.array_equal(timg.img.numpy(), data)


def test_superpose_against_jax():
    a = _smooth(8, 0)
    b = _smooth(9, 0, (48, 40))
    ja, ta = _pair(a)
    jb, tb = _pair(b, width=0.8, height=0.96, origin=[0.9, 1.2])
    t_out, j_out = dt.superpose([ta, tb]), da.superpose([ja, jb])
    assert t_out.img.shape == tuple(j_out.img.shape)
    assert t_out.dimensions == pytest.approx(j_out.dimensions, abs=1e-12)
    assert np.abs(np.asarray(t_out.origin) - np.asarray(j_out.origin)).max() <= 1e-12
    assert np.abs(t_out.img.numpy() - np.asarray(j_out.img)).max() <= 1e-5
    # Same grid: a plain sum.
    t_sum = dt.superpose([ta, ta])
    assert np.abs(t_sum.img.numpy() - 2 * a).max() <= DATA_TOL
    with pytest.raises(ValueError):
        dt.superpose([ta, _pair(_smooth())[1]])


def test_stack_zeros_and_ones_like_against_jax():
    frames = [_smooth(k) for k in range(3)]
    pairs = [_pair(f, time=float(k)) for k, f in enumerate(frames)]
    t_out = dt.stack([t for _, t in pairs])
    j_out = da.stack([j for j, _ in pairs])
    assert t_out.series and t_out.img.shape == (H, W, 3, 3) == tuple(j_out.img.shape)
    assert np.array_equal(t_out.img.numpy(), np.asarray(j_out.img))
    assert t_out.time == j_out.time == [0.0, 1.0, 2.0]
    assert type(t_out) is dt.OpticalImage
    with pytest.raises(ValueError):
        dt.stack([pairs[0][1], _pair(_smooth(0, 3, (48, 64)))[1]])

    jimg, timg = pairs[0]
    for name in ("zeros_like", "ones_like"):
        for mode in ("image", "voxels"):
            t_like, j_like = getattr(dt, name)(timg, mode), getattr(da, name)(jimg, mode)
            assert t_like.img.shape == tuple(j_like.img.shape)
            assert t_like.img.dtype == torch.float32
            assert np.array_equal(t_like.img.numpy(), np.asarray(j_like.img))
            assert t_like.scalar == j_like.scalar and t_like.dimensions == j_like.dimensions
            assert t_like.img.device == timg.img.device
    assert dt.zeros_like(timg, dtype=np.uint8).img.dtype == torch.uint8
    assert dt.ones_like(timg, "voxels", torch.float64).img.dtype == torch.float64
