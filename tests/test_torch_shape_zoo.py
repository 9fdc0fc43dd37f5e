"""The port's shape zoo against the JAX package: the point types and their
conversions, the indexing tables, ``affine_grid`` and ``displacement_grid``,
``AffineTransformation`` / ``AffineCorrection``, ``RotationCorrection`` (2-D
and a raw 3-D array), ``GeneralizedPerspectiveTransformation`` /
``GeneralizedPerspectiveCorrection``, and ``DeformationCorrection``.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Tolerances: host point maps and fitted parameters <= 1e-10 (both are
float64 numpy; the Levenberg-Marquardt fit runs the same scipy code); a
nearest-voxel warp is equal everywhere except where a source coordinate lies
within 1e-4 of a rounding tie, and those voxels are listed explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.ops import warp as jax_warp
from darsia_tpu_torch.ops import warp as torch_warp

torch.set_num_threads(1)

H, W = 96, 128
META = {"width": 1.28, "height": 0.96}
#: Host point maps and fitted parameters (float64 on both sides).
POINT_TOL = 1e-10
#: A source coordinate this close to k + 0.5 may round either way.
TIE_TOL = 1e-4


def _frame(seed=0, dtype=np.float32, shape=(H, W, 3)):
    rng = np.random.default_rng(seed)
    data = rng.random(shape)
    if dtype == np.uint8:
        return (data * 255).astype(np.uint8)
    return data.astype(dtype)


def _images(frame, **meta):
    meta = {**META, **meta}
    return da.Image(jnp.asarray(frame), **meta), dt.Image(frame, device="cpu", **meta)


def _assert_equal_off_ties(t_out, j_out, coords):
    """Equal wherever no source coordinate is within TIE_TOL of a tie."""
    frac = np.abs(coords - np.floor(coords) - 0.5)
    tie = (frac < TIE_TOL).any(axis=0)
    differ = (t_out != j_out).reshape(*tie.shape, -1).any(axis=-1)
    assert not (differ & ~tie).any(), f"{(differ & ~tie).sum()} voxels differ off the ties"
    assert tie.mean() < 0.01


# ------------------------------------------------------------------ points


def test_point_types_and_conversions_against_jax():
    jimg, timg = _images(_frame())
    jcs, tcs = jimg.coordinatesystem, timg.coordinatesystem
    raw = np.array([[3.2, 7.9], [40.0, 100.5], [95.0, 0.0]])
    for name in ("make_voxel", "make_voxel_center", "make_coordinate"):
        assert np.array_equal(np.asarray(getattr(dt, name)(raw)), np.asarray(getattr(da, name)(raw)))
    assert np.array_equal(
        np.asarray(dt.make_voxel_center(raw[0], matrix_indexing=False)),
        np.asarray(da.make_voxel_center(raw[0], matrix_indexing=False)),
    )
    pairs = {
        "voxel": (dt.make_voxel(raw), da.make_voxel(raw)),
        "center": (dt.make_voxel_center(raw), da.make_voxel_center(raw)),
        "coordinate": (dt.make_coordinate(raw / 100), da.make_coordinate(raw / 100)),
    }
    targets = [
        (dt.Coordinate, da.Coordinate),
        (dt.VoxelArray, da.VoxelArray),
        (dt.VoxelCenter, da.VoxelCenter),
    ]
    for t_pt, j_pt in pairs.values():
        for t_cls, j_cls in targets:
            t_out, j_out = t_pt.to(t_cls, tcs), j_pt.to(j_cls, jcs)
            assert type(t_out).__name__ == type(j_out).__name__
            assert np.abs(np.asarray(t_out, float) - np.asarray(j_out, float)).max() <= POINT_TOL
        for method in ("to_coordinate", "to_voxel", "to_voxel_center"):
            t_out, j_out = getattr(t_pt, method)(tcs), getattr(j_pt, method)(jcs)
            assert type(t_out).__name__ == type(j_out).__name__
            assert np.abs(np.asarray(t_out, float) - np.asarray(j_out, float)).max() <= POINT_TOL
    # Plain arrays: integers are voxels, floats coordinates.
    assert isinstance(dt.to_voxel_center(np.array([[1, 2]])), dt.VoxelCenterArray)
    assert isinstance(dt.to_voxel(raw / 100, tcs), dt.VoxelArray)
    assert type(dt.make_voxel_center(raw)[0]) is dt.VoxelCenter
    with pytest.raises(TypeError):
        dt.make_voxel(raw).to(np.ndarray)
    with pytest.raises(ValueError):
        dt.make_voxel(raw).to(dt.Coordinate)
    # The bounding box of the coordinate system.
    assert np.abs(tcs.max_coordinate - jcs.max_coordinate).max() <= POINT_TOL
    assert np.abs(tcs.min_coordinate - jcs.min_coordinate).max() <= POINT_TOL
    assert tcs.domain == pytest.approx(jcs.domain, abs=POINT_TOL)


def test_indexing_tables_against_jax():
    for indexing in ("x", "i", "xy", "ij", "xyz", "ijk"):
        for axis in "xyzijk":
            try:
                want = da.interpret_indexing(axis, indexing)
            except ValueError:
                with pytest.raises(ValueError):
                    dt.interpret_indexing(axis, indexing)
                continue
            assert dt.interpret_indexing(axis, indexing) == want
    for axis in ("x", "y", 0, 1):
        assert dt.to_matrix_indexing(axis, "xy") == da.to_matrix_indexing(axis, "xy")
    for axis in ("i", "j", 0, 1):
        assert dt.to_cartesian_indexing(axis, "ij") == da.to_cartesian_indexing(axis, "ij")
    for axis in ("i", "j", "k", 2):
        assert dt.to_cartesian_indexing(axis, "ijk") == da.to_cartesian_indexing(axis, "ijk")
    for axis in "xyz":
        assert dt.to_matrix_indexing(axis, "xyz") == da.to_matrix_indexing(axis, "xyz")
    with pytest.raises(ValueError):
        dt.to_matrix_indexing("q", "xy")
    rng = np.random.default_rng(0)
    for shape, dim in (((5,), 1), ((4, 6), 2), ((3, 4, 5), 3)):
        arr = rng.random(shape)
        assert np.array_equal(dt.matrixToCartesianIndexing(arr, dim), da.matrixToCartesianIndexing(arr, dim))
    arr = rng.random((4, 6))
    assert np.array_equal(dt.cartesianToMatrixIndexing(arr), da.cartesianToMatrixIndexing(arr))
    assert np.array_equal(dt.cartesianToMatrixIndexing(dt.matrixToCartesianIndexing(arr)), arr)


# ------------------------------------------------------------------- grids


@pytest.mark.parametrize("shape", [(12, 17), (5, 6, 7)])
def test_affine_and_displacement_grid_against_jax(shape):
    rng = np.random.default_rng(len(shape))
    dim = len(shape)
    matrix = (np.eye(dim) + 0.05 * rng.standard_normal((dim, dim))).astype(np.float32)
    translation = rng.standard_normal(dim).astype(np.float32)
    t_grid = torch_warp.affine_grid(matrix, translation, shape, "cpu")
    j_grid = np.asarray(jax_warp.affine_grid(jnp.asarray(matrix), jnp.asarray(translation), shape))
    assert t_grid.shape == (dim, *shape) and t_grid.dtype == torch.float32
    # Sums of dim float32 products, in another order: a few ulp at |x| < 32.
    assert np.abs(t_grid.numpy() - j_grid).max() <= 1e-5
    disp = rng.standard_normal((dim, *shape)).astype(np.float32)
    t_disp = torch_warp.displacement_grid(torch.from_numpy(disp))
    assert np.array_equal(t_disp.numpy(), np.asarray(jax_warp.displacement_grid(jnp.asarray(disp))))


# ------------------------------------------------------------------ affine


def _affine_pairs(cs, rng, n=6):
    """Coordinate pairs of a 3 px shift and a 0.2 degree turn."""
    src = np.asarray(cs.coordinate(rng.random((n, 2)) * np.array([H, W])))
    angle = np.deg2rad(0.2)
    R = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    shift = np.array([3 * cs.voxel_size["x"], -3 * cs.voxel_size["y"]])
    return src, shift + 1.01 * (R @ src.T).T, (shift, 1.01, R)


@pytest.mark.parametrize("isometry", [False, True])
def test_affine_transformation_fit_against_jax(isometry):
    jimg, timg = _images(_frame())
    src, dst, (shift, scale, R) = _affine_pairs(timg.coordinatesystem, np.random.default_rng(1))
    if isometry:
        dst = shift + (R @ src.T).T
    t, j = dt.AffineTransformation(2), da.AffineTransformation(2)
    assert t.fit(dt.make_coordinate(src), dt.make_coordinate(dst), {"isometry": isometry})
    j.fit(da.make_coordinate(src), da.make_coordinate(dst), {"isometry": isometry})
    for name in ("translation", "scaling", "rotation", "rotation_inv"):
        assert np.abs(np.asarray(getattr(t, name)) - np.asarray(getattr(j, name))).max() <= POINT_TOL
    # The generating parameters, recovered by the closed form.
    assert np.abs(t.rotation - R).max() <= POINT_TOL
    assert np.abs(t.translation - shift).max() <= POINT_TOL
    assert abs(t.scaling - (1.0 if isometry else scale)) <= POINT_TOL
    assert t.input_dtype is dt.Coordinate and t.output_array_dtype is dt.CoordinateArray
    probe = dt.make_coordinate(src[:3] * 0.9)
    out = t(probe)
    assert isinstance(out, dt.CoordinateArray)
    assert np.abs(np.asarray(out) - np.asarray(j(da.make_coordinate(src[:3] * 0.9)))).max() <= POINT_TOL
    back = t.inverse(out)
    assert np.abs(np.asarray(back) - np.asarray(probe)).max() <= 1e-9
    assert isinstance(t(probe[0]), dt.Coordinate)


@pytest.mark.parametrize("dim", [2, 3])
def test_affine_parameters_against_jax(dim):
    rng = np.random.default_rng(dim)
    t, j = dt.AffineTransformation(dim), da.AffineTransformation(dim)
    num_rot = 1 if dim == 2 else 3
    vector = np.concatenate([rng.standard_normal(dim), [1.1], 0.3 * rng.standard_normal(num_rot)])
    t.set_parameters_as_vector(vector)
    j.set_parameters_as_vector(vector)
    for name in ("translation", "scaling", "rotation", "rotation_inv"):
        assert np.abs(np.asarray(getattr(t, name)) - np.asarray(getattr(j, name))).max() <= POINT_TOL
    pts = rng.standard_normal((5, dim))
    assert np.abs(t.call_array(pts) - j.call_array(pts)).max() <= POINT_TOL
    assert np.abs(t.inverse_array(pts) - j.inverse_array(pts)).max() <= POINT_TOL
    with pytest.raises(ValueError):
        t.set_parameters_as_vector(vector[:-1])
    # A 3-D fit (closed form) as well.
    src = rng.standard_normal((6, dim))
    dst = t.call_array(src)
    t2, j2 = dt.AffineTransformation(dim), da.AffineTransformation(dim)
    t2.fit(src, dst)
    j2.fit(src, dst)
    assert np.abs(t2.rotation - j2.rotation).max() <= POINT_TOL
    assert np.abs(t2.translation - j2.translation).max() <= POINT_TOL


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("flavour", ["coordinate", "voxel", "center"])
def test_affine_correction_against_jax(dtype, flavour):
    frame = _frame(2, dtype)
    jimg, timg = _images(frame)
    jcs, tcs = jimg.coordinatesystem, timg.coordinatesystem
    src, dst, _ = _affine_pairs(tcs, np.random.default_rng(3))
    if flavour == "coordinate":
        t_pts = (dt.make_coordinate(src), dt.make_coordinate(dst))
        j_pts = (da.make_coordinate(src), da.make_coordinate(dst))
    else:
        make = "make_voxel" if flavour == "voxel" else "make_voxel_center"
        v_src, v_dst = np.asarray(tcs.voxel(src)), np.asarray(tcs.voxel(dst))
        t_pts = (getattr(dt, make)(v_src), getattr(dt, make)(v_dst))
        j_pts = (getattr(da, make)(v_src), getattr(da, make)(v_dst))
    t = dt.AffineCorrection(tcs, tcs, *t_pts)
    j = da.AffineCorrection(jcs, jcs, *j_pts)
    coords = t.pullback_coordinates()
    assert np.abs(coords - np.asarray(j_coords(j, jimg), float)).max() <= 1e-4  # float32 cache
    t_out = t.correct_array(torch.from_numpy(frame))
    j_out = np.asarray(j.correct_array(jnp.asarray(frame)))
    assert t_out.dtype == torch.from_numpy(frame).dtype and t_out.shape == frame.shape
    # The host-built field holds whole or half voxels: nothing near a tie
    # that the two roundings (both half-to-even) could split.
    assert np.array_equal(t_out.numpy(), j_out)
    # Through an Image, and cached per device.
    assert np.array_equal(t(timg).img.numpy(), j_out)
    assert ("coords", "cpu") in t._cache


def j_coords(j, jimg):
    """The JAX correction's cached coordinate field (built on first use)."""
    j.correct_array(jimg.img)
    return np.asarray(j._cache["coords"])


def test_affine_correction_files_against_jax(tmp_path):
    frame = _frame(4)
    jimg, timg = _images(frame)
    jcs, tcs = jimg.coordinatesystem, timg.coordinatesystem
    src, dst, _ = _affine_pairs(tcs, np.random.default_rng(5))
    t = dt.AffineCorrection(tcs, tcs, dt.make_coordinate(src), dt.make_coordinate(dst))
    j = da.AffineCorrection(jcs, jcs, da.make_coordinate(src), da.make_coordinate(dst))
    t.save(tmp_path / "torch")
    j.save(tmp_path / "jax")
    # Each package reads the other's file, into a correction that has its
    # coordinate systems.  (The loaded transformation is untyped, so it is
    # compared through its parameters and on a typed copy.)
    t_read = dt.AffineCorrection(tcs, tcs)
    t_read.load(tmp_path / "jax.npz")
    j_read = da.AffineCorrection(jcs, jcs)
    j_read.load(tmp_path / "torch.npz")
    for name in ("translation", "scaling", "rotation", "rotation_inv", "isometry"):
        want = np.asarray(getattr(t.transformation, name), dtype=float)
        for read in (t_read, j_read):
            got = np.asarray(getattr(read.transformation, name), dtype=float)
            assert np.abs(got - want).max() <= POINT_TOL
    t_read.transformation.set_dtype(dt.make_coordinate(src), dt.make_coordinate(dst))
    assert np.array_equal(
        t_read.correct_array(torch.from_numpy(frame)).numpy(),
        t.correct_array(torch.from_numpy(frame)).numpy(),
    )


def test_read_correction_refuses_an_affine_file_as_jax_does(tmp_path):
    """Mirrors darsia_tpu/corrections/base.py:167-175 with
    shape/affine.py:183-191: ``read_correction`` builds the object without
    its constructor's arguments and ``load`` then finds no transformation.
    The JAX package raises AttributeError; the port names the cause."""
    jimg, timg = _images(_frame())
    da.AffineCorrection(jimg.coordinatesystem, jimg.coordinatesystem).save(tmp_path / "affine")
    with pytest.raises(AttributeError):
        da.read_correction(tmp_path / "affine.npz")
    with pytest.raises(ValueError, match="coordinate systems"):
        dt.read_correction(tmp_path / "affine.npz")
    t = dt.AffineCorrection(timg.coordinatesystem, timg.coordinatesystem)
    t.load(tmp_path / "affine.npz")
    assert np.array_equal(t.transformation.rotation, np.eye(2))


# ---------------------------------------------------------------- rotation


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_rotation_correction_against_jax(dtype, tmp_path):
    frame = _frame(6, dtype)
    anchor = [H / 2, W / 2]
    t = dt.RotationCorrection(anchor, rotations=[np.deg2rad(0.5)])
    j = da.RotationCorrection(anchor, rotations=[np.deg2rad(0.5)])
    assert np.abs(t.rotation - j.rotation).max() <= POINT_TOL
    assert np.abs(t.rotation_inv - j.rotation_inv).max() <= POINT_TOL
    t_out = t.correct_array(torch.from_numpy(frame))
    j_out = np.asarray(j.correct_array(jnp.asarray(frame)))
    assert t_out.dtype == torch.from_numpy(frame).dtype
    coords = torch_warp.affine_grid(
        t.rotation_inv, t.anchor - t.rotation_inv @ t.anchor, (H, W), "cpu"
    ).numpy()
    _assert_equal_off_ties(t_out.numpy(), j_out, coords)
    # Files, either way, through read_correction.
    t.save(tmp_path / "torch")
    j.save(tmp_path / "jax")
    t_read = dt.read_correction(tmp_path / "jax.npz")
    j_read = da.read_correction(tmp_path / "torch.npz")
    assert isinstance(t_read, dt.RotationCorrection) and t_read.dim == 2
    assert np.array_equal(t_read.correct_array(torch.from_numpy(frame)).numpy(), t_out.numpy())
    assert np.array_equal(np.asarray(j_read.correct_array(jnp.asarray(frame))), j_out)


def test_rotation_from_isometry_against_jax():
    rng = np.random.default_rng(7)
    src = rng.random((5, 2)) * np.array([H, W])
    angle = 0.03
    R = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    dst = (R @ src.T).T + np.array([2.0, -1.0])
    kw = {"rotation_from_isometry": True, "pts_src": src, "pts_dst": dst}
    t, j = dt.RotationCorrection([10, 12], **kw), da.RotationCorrection([10, 12], **kw)
    assert np.abs(t.rotation - j.rotation).max() <= POINT_TOL
    assert np.abs(t.rotation_inv - j.rotation_inv).max() <= POINT_TOL
    assert np.abs(t.rotation - R).max() <= 1e-9
    with pytest.raises(ValueError):
        dt.RotationCorrection([10, 12])


def test_rotation_correction_3d_raw_array_against_jax():
    """A raw (12, 16, 20) array: 3-D images are not ported, the correction's
    3-D branch is."""
    volume = _frame(8, shape=(12, 16, 20))
    rotations = [(0.2, "x"), (-0.15, "z"), (0.1, "y")]
    t = dt.RotationCorrection([6, 8, 10], rotations=rotations)
    j = da.RotationCorrection([6, 8, 10], rotations=rotations)
    assert t.dim == 3
    assert np.abs(t.rotation - j.rotation).max() <= POINT_TOL
    assert np.abs(t.rotation_inv - j.rotation_inv).max() <= POINT_TOL
    t_out = t.correct_array(torch.from_numpy(volume))
    j_out = np.asarray(j.correct_array(jnp.asarray(volume)))
    coords = torch_warp.affine_grid(
        t.rotation_inv, t.anchor - t.rotation_inv @ t.anchor, volume.shape, "cpu"
    ).numpy()
    assert t_out.shape == volume.shape
    _assert_equal_off_ties(t_out.numpy(), j_out, coords)
    assert (t_out.numpy() != volume).mean() > 0.05  # it does turn the volume


# ------------------------------------------------- generalized perspective


def _perspective_pairs(rng, n=14):
    """Voxel pairs of a mild perspective (tests/fidelity's scene, at 96x128)."""
    pts = rng.random((n, 2)) * np.array([H, W])
    A = np.array([[1.02, 0.03], [-0.02, 0.99]])
    denom = 1.0 + 1e-4 * pts[:, 0] + 5e-5 * pts[:, 1]
    return pts, (pts @ A.T + np.array([2.0, -3.0])) / denom[:, None]


@pytest.mark.parametrize("strategy", [["all"], ["perspective", "perspective+bulge", "all"]])
def test_generalized_perspective_fit_against_jax(strategy):
    jimg, timg = _images(_frame())
    pts, mapped = _perspective_pairs(np.random.default_rng(9))
    t, j = dt.GeneralizedPerspectiveTransformation(), da.GeneralizedPerspectiveTransformation()
    t.fit(
        dt.make_voxel(pts),
        dt.make_voxel(mapped),
        {"coordinatesystem_dst": timg.coordinatesystem, "strategy": strategy},
    )
    j.fit(
        da.make_voxel(pts),
        da.make_voxel(mapped),
        {"coordinatesystem_dst": jimg.coordinatesystem, "strategy": strategy},
    )
    for name in ("A", "b", "c", "stretch_factor", "stretch_center_off", "bulge_factor", "bulge_center_off"):
        assert np.abs(getattr(t, name) - getattr(j, name)).max() <= POINT_TOL, name
    probe = np.random.default_rng(10).random((6, 2)) * np.array([H, W])
    assert np.abs(t.inverse_array(probe) - j.inverse_array(probe)).max() <= POINT_TOL
    # The fit inverts the distortion on its (floored) points within a voxel.
    assert np.abs(t.inverse_array(np.floor(mapped)) - np.floor(pts)).max() <= 1.5
    with pytest.raises(NotImplementedError):
        t.call_array(probe)
    with pytest.raises(ValueError):
        t.fit(dt.make_voxel(pts), dt.make_voxel(mapped))
    with pytest.raises(ValueError):
        t.fit(dt.make_voxel(pts), dt.make_voxel(mapped), {"coordinatesystem_dst": timg.coordinatesystem, "strategy": ["some"]})


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_generalized_perspective_correction_against_jax(dtype):
    frame = _frame(11, dtype)
    jimg, timg = _images(frame)
    jdst, tdst = _images(np.zeros((80, 120, 3), np.float32), width=1.2, height=0.8, origin=[0.02, 0.9])
    pts, mapped = _perspective_pairs(np.random.default_rng(12))
    mapped = mapped * np.array([80 / H, 120 / W])
    t = dt.GeneralizedPerspectiveCorrection(
        timg.coordinatesystem, tdst.coordinatesystem, dt.make_voxel(pts), dt.make_voxel(mapped)
    )
    j = da.GeneralizedPerspectiveCorrection(
        jimg.coordinatesystem, jdst.coordinatesystem, da.make_voxel(pts), da.make_voxel(mapped)
    )
    t_out, j_out = t(timg), j(jimg)
    assert t_out.img.shape == (80, 120, 3) and t_out.img.dtype == timg.img.dtype
    assert np.array_equal(t_out.img.numpy(), np.asarray(j_out.img))
    assert t_out.dimensions == pytest.approx(j_out.dimensions)
    assert np.abs(np.asarray(t_out.origin) - np.asarray(j_out.origin)).max() <= POINT_TOL
    assert t.correct_metadata()["dimensions"] == [0.8, 1.2]


def test_generalized_perspective_correction_cannot_be_saved_as_in_jax(tmp_path):
    """Mirrors darsia_tpu/corrections/shape/transformation.py:152-156: the
    class inherits a ``save`` that raises, so the registry holds it by name
    only."""
    jimg, timg = _images(_frame())
    pts, mapped = _perspective_pairs(np.random.default_rng(13))
    t = dt.GeneralizedPerspectiveCorrection(
        timg.coordinatesystem, timg.coordinatesystem, dt.make_voxel(pts), dt.make_voxel(mapped)
    )
    j = da.GeneralizedPerspectiveCorrection(
        jimg.coordinatesystem, jimg.coordinatesystem, da.make_voxel(pts), da.make_voxel(mapped)
    )
    for correction in (t, j):
        with pytest.raises(NotImplementedError):
            correction.save(tmp_path / "gp")
        with pytest.raises(NotImplementedError):
            correction.load(tmp_path / "gp.npz")
    assert "GeneralizedPerspectiveCorrection" in dt.CORRECTION_REGISTRY


def test_untyped_transformation_is_refused_as_in_jax():
    """A transformation that was never fit has no point flavour to convert
    the voxel centers to (both packages: TypeError)."""
    jimg, timg = _images(_frame())
    t = dt.AffineCorrection(timg.coordinatesystem, timg.coordinatesystem)
    j = da.AffineCorrection(jimg.coordinatesystem, jimg.coordinatesystem)
    with pytest.raises(TypeError):
        t.correct_array(timg.img)
    with pytest.raises(TypeError):
        j.correct_array(jimg.img)


# ------------------------------------------------------------- deformation


def test_deformation_correction_against_jax():
    """``DeformationCorrection`` wraps ``ImageRegistration``: equal to calling
    the registration, and to the JAX package within the fused lane's
    tolerance (tests/test_torch_pipeline.py: 2e-3 mean)."""
    from test_torch_pipeline import _base_u8

    base = _base_u8().astype(np.float32) / 255.0
    probe = np.roll(base, (1, 2), axis=(0, 1))
    jimg, timg = _images(base)
    config = {"N_patches": [2, 2], "rel_overlap": 0.2, "quality_tol": 0.01}
    t = dt.DeformationCorrection(timg, config)
    j = da.DeformationCorrection(jimg, config)
    t_out = t.correct_array(torch.from_numpy(probe))
    direct = dt.ImageRegistration(timg, **config)(dt.Image(probe, device="cpu", **META)).img
    assert torch.equal(t_out, direct)
    j_out = np.asarray(j.correct_array(jnp.asarray(probe)))
    assert np.abs(t_out.numpy() - j_out).mean() <= 2e-3
    # In a transformation chain at construction.
    chained = dt.Image(probe, transformations=[t], device="cpu", **META)
    assert torch.equal(chained.img, t_out)
