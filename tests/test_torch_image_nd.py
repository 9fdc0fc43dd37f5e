"""The port's N-d image core against the JAX package, on the CPU.

1-, 2- and 3-D coordinate systems and images, slices, ROIs, evaluation,
dimension reduction, the geometry family and files written by either
package.  Host-side metadata (origins, dimensions, voxels, coordinates) must
match exactly or to float64 rounding (1e-12); tensor data picked from the
input exactly; float32 reductions over an axis to 1e-6; integrals, which the
port accumulates in float64 on the device and the JAX package in float64
numpy, to 1e-6 relative.
"""

import datetime

import jax.numpy as jnp
import sys

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

SHAPES = {1: (30,), 2: (24, 40), 3: (12, 16, 20)}
DIMS = {1: [0.6], 2: [1.5, 2.8], 3: [0.3, 0.4, 0.5]}


def _data(dim, seed=0, channels=()):
    return np.random.default_rng(seed).random(SHAPES[dim] + tuple(channels)).astype(np.float32)


def _pair(dim, cls="ScalarImage", seed=0, channels=(), **meta):
    arr = _data(dim, seed, channels)
    meta = {"space_dim": dim, "dimensions": DIMS[dim], **meta}
    return getattr(da, cls)(jnp.asarray(arr), **meta), getattr(dt, cls)(torch.from_numpy(arr), **meta)


def _same_meta(t, j):
    assert t.shape == tuple(j.shape)
    assert t.space_dim == j.space_dim and t.indexing == j.indexing
    assert np.allclose(t.dimensions, j.dimensions, rtol=0, atol=1e-12)
    assert np.allclose(t.origin, np.asarray(j.origin), rtol=0, atol=1e-12)
    assert t.series == j.series and t.scalar == j.scalar


# ------------------------------------------------------- coordinate system


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_coordinatesystem_against_jax(dim):
    j, t = _pair(dim, origin=[0.1, 1.7, 0.9][:dim])
    cj, ct = j.coordinatesystem, t.coordinatesystem
    assert (ct.dim, ct.indexing, ct.shape, ct.axes) == (cj.dim, cj.indexing, cj.shape, cj.axes)
    assert ct.voxel_size == cj.voxel_size and ct.domain == cj.domain
    assert np.array_equal(ct.min_coordinate, cj.min_coordinate)
    assert np.array_equal(ct.max_coordinate, cj.max_coordinate)
    rng = np.random.default_rng(dim)
    voxels = rng.integers(0, 12, (6, dim))
    assert np.allclose(ct.coordinate(voxels), cj.coordinate(voxels), rtol=0, atol=1e-12)
    assert type(ct.coordinate(voxels)) is dt.CoordinateArray
    assert type(ct.coordinate(list(voxels[0]))) is dt.Coordinate
    points = np.asarray(cj.coordinate(rng.random((6, dim)) * SHAPES[dim]))
    assert np.array_equal(ct.voxel(points), cj.voxel(points))
    assert type(ct.voxel(points)) is dt.VoxelArray and type(ct.voxel(points[0])) is dt.Voxel
    vectors = rng.standard_normal((5, dim))
    for name in ("coordinate_vector", "voxel_vector", "pixel_vector"):
        assert np.array_equal(getattr(ct, name)(vectors), getattr(cj, name)(vectors))
        assert getattr(ct, name)(vectors[0]).shape == (dim,)
    assert np.array_equal(ct.voxels, cj.voxels)
    assert np.allclose(ct.coordinates, cj.coordinates, rtol=0, atol=1e-12)
    for axis in "xyz"[:dim]:
        assert ct.length(5, axis) == cj.length(5, axis)
        assert ct.num_voxels(0.13, axis) == cj.num_voxels(0.13, axis)
    with pytest.raises(ValueError):
        ct.length(1, "xyz"[dim] if dim < 3 else "w")


def test_check_equal_coordinatesystems_against_jax():
    j, t = _pair(3)
    j2, t2 = _pair(3, origin=[0.0, 0.5, 0.4])
    j3 = da.ScalarImage(jnp.zeros((6, 16, 20)), space_dim=3, dimensions=DIMS[3])
    t3 = dt.ScalarImage(torch.zeros((6, 16, 20)), space_dim=3, dimensions=DIMS[3])
    j4, t4 = _pair(2)
    for (ja, jb), (ta, tb) in (((j, j), (t, t)), ((j, j2), (t, t2)), ((j, j3), (t, t3)), ((j, j4), (t, t4))):
        for exclude_size in (False, True):
            want = da.image.coordinatesystem.check_equal_coordinatesystems(
                ja.coordinatesystem, jb.coordinatesystem, exclude_size
            ) if (ja.space_dim == jb.space_dim) else None
            got = dt.check_equal_coordinatesystems(ta.coordinatesystem, tb.coordinatesystem, exclude_size) \
                if (ta.space_dim == tb.space_dim) else None
            assert got == want
    assert t.coordinatesystem == t.coordinatesystem and t.coordinatesystem != t2.coordinatesystem


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_tensor_coordinate_maps_against_jax(dim):
    from darsia_tpu.image.coordinatesystem import coordinates_to_voxels, voxels_to_coordinates

    rng = np.random.default_rng(10 + dim)
    voxels = (rng.random((7, dim)) * 10).astype(np.float32)
    origin = np.asarray([0.1, 1.7, 0.9][:dim], np.float32)
    size = np.asarray([0.01, 0.02, 0.04][:dim], np.float32)
    indexing = "ijk"[:dim]
    want = np.array(voxels_to_coordinates(jnp.asarray(voxels), jnp.asarray(origin), jnp.asarray(size), indexing))
    got = dt.voxels_to_coordinates(torch.from_numpy(voxels), torch.from_numpy(origin), torch.from_numpy(size), indexing)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    for continuous in (True, False):
        back_j = np.asarray(coordinates_to_voxels(jnp.asarray(want), jnp.asarray(origin), jnp.asarray(size), indexing, continuous))
        back_t = dt.coordinates_to_voxels(torch.from_numpy(want), torch.from_numpy(origin), torch.from_numpy(size), indexing, continuous)
        assert np.abs(back_t.numpy() - back_j).max() <= (1e-4 if continuous else 0)
    assert back_t.dtype == torch.int32


# ---------------------------------------------------------------- metadata


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_image_metadata_against_jax(dim):
    j, t = _pair(dim, name="volume")
    _same_meta(t, j)
    # The default origin lets the reversed axes (y; y and z) span [0, dimension].
    assert t.origin.tolist() == {1: [0.0], 2: [0.0, 1.5], 3: [0.0, 0.5, 0.3]}[dim]
    assert t.space_num == j.space_num == int(np.prod(SHAPES[dim]))
    assert t.num_voxels == j.num_voxels and t.voxel_size == j.voxel_size
    assert np.allclose(t.opposite_corner, j.opposite_corner, rtol=0, atol=1e-12)
    assert type(t.opposite_corner) is dt.Coordinate
    if dim < 3:
        assert np.allclose(t.domain, j.domain, rtol=0, atol=1e-12)
    else:
        for img in (j, t):
            with pytest.raises(NotImplementedError):
                img.domain
    meta = t.metadata()
    assert meta["space_dim"] == dim and meta["indexing"] == "ijk"[:dim]
    again = type(t)(t.img, **meta)
    _same_meta(again, j)
    assert set(t.shape_metadata()) == set(j.shape_metadata())
    assert np.array_equal(t.as_numpy(), j.as_numpy())
    assert t.copy().img is not t.img and torch.equal(t.copy().img, t.img)


def test_height_width_depth_and_refusals():
    arr = _data(3)
    j = da.ScalarImage(jnp.asarray(arr), space_dim=3, height=0.3, width=0.4, depth=0.5)
    t = dt.ScalarImage(torch.from_numpy(arr), space_dim=3, height=0.3, width=0.4, depth=0.5)
    _same_meta(t, j)
    assert t.dimensions == [0.3, 0.4, 0.5]
    with pytest.raises(ValueError):
        dt.ScalarImage(torch.from_numpy(arr), space_dim=4)
    with pytest.raises(ValueError):
        dt.ScalarImage(torch.from_numpy(arr), space_dim=3, indexing="ij")
    with pytest.raises(ValueError, match="does not fit"):
        dt.ScalarImage(torch.from_numpy(arr), space_dim=2)
    vector = dt.Image(torch.from_numpy(_data(3, channels=(2,))), space_dim=3)
    assert vector.range_dim == 1 and not vector.scalar


def test_reference_time_against_jax():
    t0 = datetime.datetime(2024, 3, 1, 12)
    dates = [t0 + datetime.timedelta(minutes=10 * k) for k in range(3)]
    arr = np.random.default_rng(1).random((6, 8, 3)).astype(np.float32)
    j = da.ScalarImage(jnp.asarray(arr), series=True, date=dates)
    t = dt.ScalarImage(torch.from_numpy(arr), series=True, date=dates)
    assert t.time == j.time == [0.0, 600.0, 1200.0]
    for img in (j, t):
        img.update_reference_time(t0 - datetime.timedelta(minutes=5))
    assert t.time == j.time == [300.0, 900.0, 1500.0]
    for img in (j, t):
        img.update_reference_time(100)
    assert t.time == j.time == [200.0, 800.0, 1400.0]
    for img in (j, t):
        img.reset_reference_time()
    assert t.time == j.time == [0.0, 600.0, 1200.0] and t.reference_date == t0
    j = da.ScalarImage(jnp.asarray(arr), series=True, time=[5.0, 7.0, None])
    t = dt.ScalarImage(torch.from_numpy(arr), series=True, time=[5.0, 7.0, None])
    for img in (j, t):
        img.reset_reference_time()
    assert t.time == j.time == [0.0, 2.0, None]
    single = dt.ScalarImage(torch.from_numpy(arr[..., 0]), time=30.0)
    single.update_reference_time(10)
    assert single.time == 20.0


# ------------------------------------------------------ subregion and slice


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_subregion_against_jax(dim):
    j, t = _pair(dim, origin=[0.1, 1.7, 0.9][:dim])
    box = tuple(slice(2 + d, SHAPES[dim][d] - 3) for d in range(dim))
    sj, st = j.subregion(box), t.subregion(box)
    _same_meta(st, sj)
    assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
    corners = np.asarray(j.coordinatesystem.coordinate([[2 + d for d in range(dim)], [9] * dim]))
    sj, st = j.subregion(da.make_coordinate(corners)), t.subregion(dt.make_coordinate(corners))
    _same_meta(st, sj)
    assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
    voxels = [[1] * dim, [7] * dim]
    sj, st = j.subregion(da.make_voxel(voxels)), t.subregion(dt.make_voxel(voxels))
    _same_meta(st, sj)
    assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
    open_ended = tuple(slice(None, 5) if d == 0 else slice(3, None) for d in range(dim))
    _same_meta(t.subregion(open_ended), j.subregion(open_ended))
    with pytest.raises(ValueError):
        t.subregion([[0] * dim, [3] * dim])


@pytest.mark.parametrize("dim", [2, 3])
def test_slice_by_index_against_jax(dim):
    j, t = _pair(dim, origin=[0.1, 1.7, 0.9][:dim])
    for axis in range(dim):
        sj, st = j.slice(3, axis), t.slice(3, axis)
        _same_meta(st, sj)
        assert type(st) is dt.ScalarImage and st.space_dim == dim - 1
        assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
        assert np.array_equal(st.img.numpy(), np.take(_data(dim), 3, axis=axis))


def test_slice_by_coordinate_against_jax_2d_and_z():
    """Where the JAX package's two axis tables agree (2-D, and z in 3-D),
    slices by coordinate match it."""
    j, t = _pair(2, origin=[0.1, 1.7])
    for cut, axis in ((0.8, "x"), (2.0, "x"), (1.1, "y"), (0.3, "y")):
        sj, st = j.slice(cut, axis), t.slice(cut, axis)
        _same_meta(st, sj)
        assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
    j, t = _pair(3)
    for cut in (0.01, 0.17, 0.29):
        sj, st = j.slice(cut, "z"), t.slice(cut, "z")
        _same_meta(st, sj)
        assert np.array_equal(st.img.numpy(), np.asarray(sj.img))


def test_slice_by_coordinate_in_3d_follows_the_coordinate_system():
    """A slice at a coordinate is the index slice at that coordinate's voxel,
    along the matrix axis the coordinate system maps the Cartesian axis to
    (x -> 1, y -> 2, z -> 0).

    Not mirrored: the JAX package takes the matrix axis of "x" and "y" from
    ``to_matrix_indexing`` (darsia_tpu image/image.py:458-464), whose 3-D
    table (image/indexing.py: x -> k, y -> j) swaps the two against
    ``interpret_indexing`` (x -> axis 1, y -> axis 2), which its coordinate
    system and ``reduce_axis`` follow; the cut index is then read from the
    other axis, where the zero coordinate gives the voxel count, and XLA
    clamps it: its "x" slice is the last "y" plane whatever the cut."""
    j, t = _pair(3)
    cs = t.coordinatesystem
    for axis, matrix_axis in (("x", 1), ("y", 2), ("z", 0)):
        for index in (0, 5, SHAPES[3][matrix_axis] - 1):
            voxel = np.zeros(3)
            voxel[matrix_axis] = index + 0.5
            cut = float(np.asarray(cs.coordinate(voxel))["xyz".find(axis)])
            by_coordinate, by_index = t.slice(cut, axis), t.slice(index, matrix_axis)
            assert torch.equal(by_coordinate.img, by_index.img)
            assert by_coordinate.dimensions == by_index.dimensions
            assert np.array_equal(by_coordinate.origin, by_index.origin)
    # The JAX package: the same plane for every x cut, an index-axis-2 plane.
    planes = [np.asarray(j.slice(cut, "x").img) for cut in (0.05, 0.2, 0.35)]
    assert all(np.array_equal(planes[0], p) for p in planes[1:])
    assert np.array_equal(planes[0], _data(3)[:, :, -1])
    # Beyond the image the port clamps to the last plane of the right axis.
    assert torch.equal(t.slice(0.9, "x").img, t.slice(SHAPES[3][1] - 1, 1).img)


@pytest.mark.parametrize(
    "dim, cut, axis",
    [
        (2, 5.0, "x"),  # beyond the right edge: the last column
        (2, -0.05, "x"),  # voxel -3: counted from the end
        (2, -3.0, "x"),  # voxel -45: the first column
        (2, 9.0, "y"),
        (2, -2.0, "y"),
        (3, 0.45, "z"),
        (3, -0.02, "z"),
        (2, 30, 0),
        (2, -2, 0),
        (2, -30, 0),
        (2, 45, 1),
        (3, 25, 2),
        (3, -40, 1),
    ],
)
def test_slice_outside_the_image_against_jax(dim, cut, axis):
    """A cut outside the image gives the plane the JAX package gives
    (darsia_tpu image/image.py:466-473 index with a static integer: a negative
    one counts from the end, and XLA clamps what still lies outside)."""
    j, t = _pair(dim, **({"origin": [0.1, 1.7]} if dim == 2 else {}))
    sj, st = j.slice(cut, axis), t.slice(cut, axis)
    _same_meta(st, sj)
    assert np.array_equal(st.img.numpy(), np.asarray(sj.img))


@pytest.mark.parametrize("mode", ["average", "sum", "slice"])
@pytest.mark.parametrize("axis", ["x", "y", "z", 0, 1, 2])
def test_reduce_axis_against_jax(axis, mode):
    j, t = _pair(3, origin=[0.1, 1.7, 0.9])
    kw = {"slice_idx": 4} if mode == "slice" else {}
    rj, rt = da.reduce_axis(j, axis, mode=mode, **kw), dt.reduce_axis(t, axis, mode=mode, **kw)
    _same_meta(rt, rj)
    assert np.abs(rt.img.numpy() - np.asarray(rj.img)).max() <= (0 if mode == "slice" else 1e-5)
    red_j, red_t = da.AxisReduction(axis, 3, mode, **kw), dt.AxisReduction(axis, 3, mode, **kw)
    assert (red_t.index, red_t.axis) == (red_j.index, red_j.axis)


def test_reduce_axis_2d_uint8_and_refusals():
    arr = (np.random.default_rng(2).random((10, 14)) * 255).astype(np.uint8)
    j = da.ScalarImage(jnp.asarray(arr), width=1.4, height=1.0)
    t = dt.ScalarImage(torch.from_numpy(arr), width=1.4, height=1.0)
    for axis in ("x", "y"):
        rj, rt = da.reduce_axis(j, axis), dt.reduce_axis(t, axis)
        _same_meta(rt, rj)
        assert rt.img.dtype == torch.float32
        assert np.abs(rt.img.numpy() - np.asarray(rj.img)).max() <= 1e-4
    with pytest.raises(ValueError):
        dt.reduce_axis(t, "z")
    with pytest.raises(ValueError):
        dt.reduce_axis(t, 2)
    with pytest.raises(ValueError, match="not supported"):
        dt.reduce_axis(t, "x", mode="max")


def test_extrude_along_axis_against_jax():
    """The extruded origin is ``[height, *origin]`` (darsia_tpu signals/
    reduction/dimensionreduction.py:102-112), not the 3-D default
    ``[0, y-extent, z-extent]``; mirrored."""
    j, t = _pair(2)
    ej, et = da.extrude_along_axis(j, 0.3, 5), dt.extrude_along_axis(t, 0.3, 5)
    _same_meta(et, ej)
    assert et.shape == (5, 24, 40) and et.origin.tolist() == [0.3, 0.0, 1.5]
    assert np.array_equal(et.img.numpy(), np.asarray(ej.img))
    assert all(torch.equal(et.img[k], t.img) for k in range(5))
    with pytest.raises(ValueError):
        dt.extrude_along_axis(et, 0.1, 2)


# ------------------------------------------------------------ roi and eval


def test_roi_against_jax():
    j, t = _pair(2, origin=[0.1, 1.7])
    polygon = [[0.5, 0.6], [2.2, 0.5], [2.4, 1.5], [1.2, 1.6]]
    rj, rt = da.image.roi.ROI(polygon), dt.ROI(polygon)
    assert rt.bounds == rj.bounds and repr(rt) == repr(rj)
    assert np.array_equal(rt.vertices, rj.vertices)
    assert np.array_equal(rt.mask(t), rj.mask(j))
    assert 0 < rt.mask(t).sum() < t.space_num
    for point in ([1.5, 1.0], [0.2, 0.3], [2.35, 1.45]):
        assert rt.contains(point) == rj.contains(point)
    sj, st = j.roi(rj), t.roi(rt)
    _same_meta(st, sj)
    assert np.array_equal(st.img.numpy(), np.asarray(sj.img))
    assert torch.equal(rt(t).img, st.img)
    with pytest.raises(ValueError):
        dt.ROI([[0, 0, 0], [1, 1, 1], [0, 1, 0]])


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_eval_against_jax(dim):
    j, t = _pair(dim, origin=[0.1, 1.7, 0.9][:dim])
    rng = np.random.default_rng(20 + dim)
    voxels = rng.integers(-2, 45, (8, dim))  # clipped to the image
    assert np.array_equal(t.eval(dt.make_voxel(voxels)), j.eval(da.make_voxel(voxels)))
    assert np.array_equal(t.eval(voxels), j.eval(voxels))
    points = np.asarray(j.coordinatesystem.coordinate(rng.random((8, dim)) * SHAPES[dim]))
    assert np.array_equal(t.eval(dt.make_coordinate(points)), j.eval(da.make_coordinate(points)))
    assert np.array_equal(t.eval(points), j.eval(points))
    one = t.eval(points[0])
    assert one.shape == () and one == j.eval(points[0])
    jc, tc = _pair(dim, cls="Image", channels=(3,))
    assert np.array_equal(tc.eval(voxels), jc.eval(voxels)) and tc.eval(voxels).shape == (8, 3)


def test_reset_origin_and_resize_against_jax():
    j, t = _pair(3, origin=[0.1, 1.7, 0.9])
    old_j, old_t = j.reset_origin(return_image=True), t.reset_origin(return_image=True)
    _same_meta(t, j)
    _same_meta(old_t, old_j)
    assert t.origin.tolist() == [0.0, 0.5, 0.3] and old_t.origin.tolist() == [0.1, 1.7, 0.9]
    assert t.reset_origin() is None
    j, t = _pair(2)
    j.resize(0.5, 0.75)
    t.resize(0.5, 0.75)
    _same_meta(t, j)
    assert t.shape == (18, 20)
    assert np.abs(t.img.numpy() - np.asarray(j.img)).max() <= 1e-6


# --------------------------------------------------------- files and export


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_to_csv_and_write_byte_for_byte(dim, tmp_path):
    j, t = _pair(dim, origin=[0.1, 1.7, 0.9][:dim])
    header = ",".join("xyz"[:dim]) + ",c"
    for k, kw in enumerate(({}, {"header": header, "float_format": "{:.5f}"}, {"delimiter": ";", "header": "None"})):
        j.to_csv(tmp_path / f"j{k}.csv", **kw)
        t.to_csv(tmp_path / f"t{k}.csv", **kw)
        assert (tmp_path / f"t{k}.csv").read_bytes() == (tmp_path / f"j{k}.csv").read_bytes()
    for suffix in (".npy", ".csv"):
        j.write(tmp_path / f"wj{suffix}")
        t.write(tmp_path / f"wt{suffix}")
        assert (tmp_path / f"wt{suffix}").read_bytes() == (tmp_path / f"wj{suffix}").read_bytes()
    with pytest.raises(ValueError, match="columns"):
        t.to_csv(tmp_path / "bad.csv", header="a,b,c,d,e")
    if dim == 2:
        # Image files through OpenCV: the same bytes as the JAX package's.
        for suffix in (".png", ".jpg", ".tif"):
            j.write(tmp_path / f"wj{suffix}")
            t.write(tmp_path / f"wt{suffix}")
            assert (tmp_path / f"wt{suffix}").read_bytes() == (tmp_path / f"wj{suffix}").read_bytes()
    with pytest.raises(NotImplementedError, match="not supported"):
        t.write(tmp_path / "image.xyz")


def test_unported_views_name_their_library(monkeypatch, tmp_path):
    _, t = _pair(2)
    photo = dt.OpticalImage(torch.zeros(4, 5, 3))
    # The VTK writer needs no library.
    t.to_vtk(tmp_path / "x")
    assert (tmp_path / "x.vtk").read_text().startswith("# vtk DataFile Version 3.0\n")
    # The views draw with matplotlib and plotly: where those do not import,
    # they say so.
    for name in ("matplotlib.pyplot", "plotly", "plotly.express"):
        monkeypatch.setitem(sys.modules, name, None)
    for call, library in (
        (t.show, "matplotlib"),
        (t.show_matplotlib, "matplotlib"),
        (t.show_plotly, "plotly"),
    ):
        with pytest.raises(ImportError, match=library):
            call()
    # Writing and encoding need OpenCV: where it does not import, they say so.
    monkeypatch.setitem(sys.modules, "cv2", None)
    for call in (lambda: photo.write("x.jpg"), lambda: photo.encode(".png")):
        with pytest.raises(ImportError, match="cv2"):
            call()
    series = dt.ScalarImage(torch.zeros(4, 5, 2), series=True, time=[0.0, 1.0])
    with pytest.raises(ValueError, match="non-series"):
        series.to_csv("unused.csv")


def test_add_grid_against_jax():
    arr = (np.random.default_rng(3).random((60, 80, 3)) * 255).astype(np.uint8)
    meta = {"width": 0.8, "height": 0.6}
    kw = {"dx": 0.2, "dy": 0.25, "thickness": 3}
    for data in (arr, (arr / 255).astype(np.float32)):
        want = np.asarray(da.OpticalImage(jnp.asarray(data), **meta).add_grid(**kw).img)
        got = dt.OpticalImage(torch.from_numpy(data), **meta).add_grid(**kw)
        assert type(got) is dt.OpticalImage and np.array_equal(got.img.numpy(), want)
    assert (got.img.numpy() != data).any()


@pytest.mark.parametrize("dim", [1, 3])
def test_files_cross_the_packages(dim, tmp_path):
    """An image saved by either package is read by the other, data and
    metadata (``space_dim``, ``indexing``, origin, dimensions, time)."""
    meta = {"origin": [0.1, 1.7, 0.9][:dim], "name": "ct", "time": 12.5}
    j, t = _pair(dim, **meta)
    j.save(tmp_path / "from_jax")
    t.save(tmp_path / "from_torch")
    read_t = dt.imread(tmp_path / "from_jax.npz", device="cpu")
    read_j = da.imread(tmp_path / "from_torch.npz")
    for read, cls in ((read_t, dt.ScalarImage), (read_j, da.ScalarImage)):
        assert type(read) is cls and read.name == "ct" and read.time == 12.5
        meta_read = read.metadata()
        assert meta_read["space_dim"] == dim and meta_read["indexing"] == "ijk"[:dim]
    _same_meta(read_t, j)
    _same_meta(t, read_j)
    assert type(read_t.origin) is np.ndarray
    assert np.array_equal(read_t.img.numpy(), _data(dim))
    assert np.array_equal(np.asarray(read_j.img), _data(dim))
    assert read_t.slice(2, 0).shape == SHAPES[dim][1:] if dim == 3 else True


def test_extensive_image_is_written_and_read(tmp_path):
    _, t = _pair(3)
    extensive = t.geometry().make_extensive(t)
    assert type(extensive) is dt.ExtensiveImage and isinstance(extensive, dt.ScalarImage)
    extensive.save(tmp_path / "mass")
    back = dt.imread(tmp_path / "mass.npz", device="cpu")
    assert type(back) is dt.ExtensiveImage and torch.equal(back.img, extensive.img)
    assert type(da.imread(tmp_path / "mass.npz")) is da.ExtensiveImage


# ----------------------------------------------- transformation and resize


def test_coordinate_transformation_against_jax():
    rng = np.random.default_rng(4)
    src = (rng.random((40, 56)) * 255).astype(np.uint8)
    js = da.ScalarImage(jnp.asarray(src), width=1.4, height=1.0)
    ts = dt.ScalarImage(torch.from_numpy(src), width=1.4, height=1.0)
    jd = da.ScalarImage(jnp.zeros((48, 60)), width=1.5, height=1.2, origin=[0.2, 1.3])
    td = dt.ScalarImage(torch.zeros((48, 60)), width=1.5, height=1.2, origin=[0.2, 1.3])
    pts = np.array([[0.3, 0.2], [1.2, 0.25], [1.1, 0.9], [0.4, 0.8]])
    moved = pts * 0.98 + [0.15, 0.1]
    for make_j, make_t in ((da.make_coordinate, dt.make_coordinate),):
        cj = da.image.coordinatetransformation.CoordinateTransformation(
            js.coordinatesystem, jd.coordinatesystem, make_j(pts), make_j(moved)
        )
        ct = dt.CoordinateTransformation(ts.coordinatesystem, td.coordinatesystem, make_t(pts), make_t(moved))
        assert ct.find_intersection() == cj.find_intersection()
        out_j, out_t = cj(js), ct(ts)
        _same_meta(out_t, out_j)
        # Nearest-voxel picks of a float64 map: equal but for rounding ties.
        assert (out_t.img.numpy() != np.asarray(out_j.img)).mean() <= 1e-3
        meta_j, meta_t = cj.correct_metadata(js), ct.correct_metadata(ts)
        assert meta_t["dimensions"] == meta_j["dimensions"]
        assert np.array_equal(meta_t["origin"], np.asarray(meta_j["origin"]))
    voxel_pts = np.array([[5.0, 6.0], [30.0, 8.0], [28.0, 50.0], [8.0, 44.0]])
    cj = da.image.coordinatetransformation.CoordinateTransformation(
        js.coordinatesystem, jd.coordinatesystem, da.make_voxel(voxel_pts), da.make_voxel(voxel_pts + 2)
    )
    ct = dt.CoordinateTransformation(
        ts.coordinatesystem, td.coordinatesystem, dt.make_voxel(voxel_pts), dt.make_voxel(voxel_pts + 2)
    )
    assert ct.find_intersection() == cj.find_intersection()
    far = dt.ScalarImage(torch.zeros((48, 60)), width=1.5, height=1.2, origin=[9.0, 9.0])
    with pytest.raises(ValueError, match="Empty"):
        dt.CoordinateTransformation(
            ts.coordinatesystem, far.coordinatesystem, dt.make_coordinate(pts), dt.make_coordinate(pts)
        ).find_intersection()


def test_subregions_module_keeps_its_names():
    from darsia_tpu_torch.corrections.shape.quad import extract_quadrilateral_ROI
    from darsia_tpu_torch.image import subregions

    assert subregions.extract_quadrilateral_ROI is extract_quadrilateral_ROI
    assert dt.extract_quadrilateral_ROI is extract_quadrilateral_ROI
    assert subregions.InterpolationOption.__args__ == ("inter_nearest", "inter_linear", "inter_area")


def test_equalize_voxel_size_and_uniform_refinement_against_jax():
    j, t = _pair(2)  # voxels of 0.0625 x 0.07
    for kw in ({}, {"voxel_size": 0.1}, {"interpolation": "inter_nearest"}):
        ej, et = da.equalize_voxel_size(j, **kw), dt.equalize_voxel_size(t, **kw)
        _same_meta(et, ej)
        assert abs(et.voxel_size[0] - et.voxel_size[1]) < 2e-3
        assert np.abs(et.img.numpy() - np.asarray(ej.img)).max() <= 1e-6
    for levels in (1, 2, -1, -2, 0):
        rj, rt = da.uniform_refinement(j, levels), dt.uniform_refinement(t, levels)
        _same_meta(rt, rj)
        assert rt.shape == tuple(max(int(round(n * 2.0**levels)), 1) for n in (24, 40))
        assert np.abs(rt.img.numpy() - np.asarray(rj.img)).max() <= 1e-6


# ------------------------------------------------------------------ geometry


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_geometry_against_jax(dim):
    j, t = _pair(dim)
    gj, gt = j.geometry(), t.geometry()
    assert (gt.space_dim, gt.num_voxels, gt.dimensions, gt.voxel_size) == (
        gj.space_dim, gj.num_voxels, gj.dimensions, gj.voxel_size
    )
    assert gt.voxel_volume == gj.voxel_volume
    want = gj.integrate(j)
    got = gt.integrate(t)
    assert isinstance(got, float) and abs(got - want) <= 1e-6 * abs(want)
    exact = _data(dim).astype(np.float64).sum() * np.prod(gt.voxel_size)
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(t.integral() - j.integral()) <= 1e-6 * abs(want)
    # Tensors, numpy arrays and range axes.
    assert gt.integrate(t.img) == got
    assert abs(gt.integrate(_data(dim), device="cpu") - got) <= 1e-12
    jc, tc = _pair(dim, cls="Image", channels=(3,))
    assert np.allclose(gt.integrate(tc), gj.integrate(jc), rtol=1e-6, atol=0)
    assert gt.integrate(tc).shape == (3,)
    # Extensive data: the plain sum.
    ext_j, ext_t = gj.make_extensive(j), gt.make_extensive(t)
    assert type(ext_t) is dt.ExtensiveImage
    assert np.abs(ext_t.img.numpy() - np.asarray(ext_j.img)).max() <= 1e-9
    assert abs(gt.integrate(ext_t) - float(gj.integrate(ext_j))) <= 2e-6 * abs(want)
    # Normalisation and a sub-geometry.
    nj, rj = gj.normalize(j * 2.5, j, return_ratio=True)
    nt, rt = gt.normalize(t * 2.5, t, return_ratio=True)
    assert abs(rt - rj) <= 1e-6 and np.abs(nt.img.numpy() - np.asarray(nj.img)).max() <= 1e-6
    assert type(gt.normalize(t * 2.5, t)) is dt.ScalarImage
    roi = np.array([[0.02] * dim, [0.21] * dim])
    sj, st = gj.subregion(roi), gt.subregion(roi)
    assert (st.num_voxels, st.dimensions) == (sj.num_voxels, sj.dimensions)
    with pytest.raises(NotImplementedError):
        tc.integral()
    with pytest.raises(ValueError):
        dt.Geometry(dim, SHAPES[dim])
    by_size = dt.Geometry(dim, SHAPES[dim], voxel_size=gt.voxel_size)
    assert np.allclose(by_size.dimensions, gt.dimensions)


def test_geometry_integrates_where_the_data_lies(monkeypatch):
    """A numpy array goes to the card unless the caller names a device (and
    raises without one); the weight map is fitted to data of another shape on
    the data's device, and the host-side weights never become a tensor
    elsewhere."""
    j, t = _pair(2)
    weight = (0.2 + np.random.default_rng(8).random(SHAPES[2])).astype(np.float32)
    gt = dt.WeightedGeometry(weight, **t.shape_metadata())
    gj = da.measure.integration.WeightedGeometry(weight, **j.shape_metadata())
    got = gt.integrate(_data(2), device="cpu")
    assert abs(got - gj.integrate(j)) <= 1e-6 * abs(got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            gt.integrate(_data(2))
    # Every tensor made while the map is resized and cut lies with the data.
    devices = []
    original = torch.Tensor.to

    def record(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        devices.append(out.device)
        return out

    monkeypatch.setattr(torch.Tensor, "to", record)
    half = dt.resize(t, shape=(12, 20))
    gt.integrate(half)
    gt.subregion(dt.make_coordinate([[0.2, 0.3], [0.9, 1.4]]))
    monkeypatch.undo()
    assert devices and all(device == half.device for device in devices)


@pytest.mark.parametrize(
    "name", ["WeightedGeometry", "ExtrudedGeometry", "PorousGeometry", "ExtrudedPorousGeometry"]
)
@pytest.mark.parametrize("weights", ["scalar", "array", "image"])
def test_weighted_geometries_against_jax(name, weights):
    j, t = _pair(2)
    rng = np.random.default_rng(5)
    first = (0.2 + rng.random(SHAPES[2])).astype(np.float32)
    second = (0.01 + 0.02 * rng.random(SHAPES[2])).astype(np.float32)
    if name != "ExtrudedPorousGeometry":  # its update divides by the weight
        first[3, 4] = np.nan  # counted as 0
    meta = {"space_dim": 2, "dimensions": DIMS[2]}

    def weight_args(pkg, array):
        if weights == "scalar":
            return 0.3
        if weights == "array" or (pkg is da and name == "WeightedGeometry"):
            return array  # the JAX package's base class takes no Image
        if pkg is da:
            return da.ScalarImage(jnp.asarray(array), **meta)
        return dt.ScalarImage(torch.from_numpy(array), **meta)

    def make(pkg, img):
        args = [weight_args(pkg, first)]
        if name == "ExtrudedPorousGeometry":
            args.append(weight_args(pkg, second) if weights != "scalar" else 0.02)
        return getattr(pkg.measure.integration if pkg is da else pkg, name)(*args, **img.shape_metadata())

    gj, gt = make(da, j), make(dt, t)
    assert np.allclose(gt.voxel_volume, gj.voxel_volume, rtol=1e-12, atol=0, equal_nan=True)
    want, got = gj.integrate(j), gt.integrate(t)
    assert isinstance(got, float) and abs(got - want) <= 1e-6 * abs(want)
    jc, tc = _pair(2, cls="Image", channels=(3,), seed=6)
    assert np.allclose(gt.integrate(tc), gj.integrate(jc), rtol=1e-6, atol=0)
    assert np.abs(gt.make_extensive(t).img.numpy() - np.asarray(gj.make_extensive(j).img)).max() <= 1e-9
    # Data at half the resolution: the cached volume is resized (2-D only).
    half_j, half_t = da.resize(j, shape=(12, 20)), dt.resize(t, shape=(12, 20))
    assert abs(gt.integrate(half_t) - gj.integrate(half_j)) <= 2e-6 * abs(want)
    assert abs(gt.integrate(t) - want) <= 1e-6 * abs(want)  # and back
    roi = [[0.2, 0.3], [0.9, 1.4]]
    sj, st = gj.subregion(da.make_coordinate(roi)), gt.subregion(dt.make_coordinate(roi))
    assert type(st) is dt.WeightedGeometry and st.num_voxels == sj.num_voxels
    assert np.allclose(st.voxel_volume, sj.voxel_volume, rtol=1e-12, atol=0, equal_nan=True)
    if name == "ExtrudedPorousGeometry":
        gj.update(weight_args(da, 2 * second) if weights != "scalar" else 0.05)
        gt.update(weight_args(dt, 2 * second) if weights != "scalar" else 0.05)
        assert abs(gt.integrate(t) - gj.integrate(j)) <= 1e-6 * abs(want)
    if weights == "array":
        with pytest.raises(ValueError, match="dimensions"):
            getattr(dt, name)(first[0], *([second[0]] if name == "ExtrudedPorousGeometry" else []), **t.shape_metadata())
