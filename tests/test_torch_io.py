"""The port's image files against the JAX package: ``Image.save``, ``imread``
for ``.npz`` and ``.npy`` (files, lists, folders), the pickle-safe npz
reader, and ``PatchwiseIlluminationCorrection`` from paths.

Each package writes files that the other reads: data bitwise, metadata to
1e-12.  A file of the JAX package pickles its origin as that package's
``Coordinate``; the port reads it without importing the package (the
subprocess of ``tests/test_torch_isolation.py`` holds that with the package
blocked).
"""

import datetime
import pickle

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.utils.npz import load_npz

torch.set_num_threads(1)

H, W = 96, 128
META = {"width": 1.28, "height": 0.96}


def _frame(seed=0, dtype=np.float32, shape=(H, W, 3)):
    data = np.random.default_rng(seed).random(shape)
    return (data * 255).astype(np.uint8) if dtype == np.uint8 else data.astype(dtype)


def _same_metadata(t_img, j_img):
    assert type(t_img).__name__ == type(j_img).__name__
    assert t_img.dimensions == pytest.approx(j_img.dimensions, abs=1e-12)
    assert np.abs(np.asarray(t_img.origin) - np.asarray(j_img.origin, float)).max() <= 1e-12
    for name in ("space_dim", "indexing", "series", "scalar", "date", "reference_date", "time", "name"):
        assert getattr(t_img, name) == getattr(j_img, name), name


CASES = {
    "optical u8": ("OpticalImage", np.uint8, (H, W, 3), {"name": "probe"}),
    "scalar f32": ("ScalarImage", np.float32, (H, W), {"origin": [0.1, 1.3]}),
    "dated": (
        "OpticalImage",
        np.float32,
        (H, W, 3),
        {
            "date": datetime.datetime(2024, 3, 1, 12, 0, 5),
            "reference_date": datetime.datetime(2024, 3, 1, 12, 0, 0),
        },
    ),
    "series": ("OpticalImage", np.uint8, (H, W, 2, 3), {"series": True, "time": [0.0, 30.0]}),
    "plain": ("Image", np.float32, (H, W, 2), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_image_files_go_both_ways(case, tmp_path):
    cls, dtype, shape, extra = CASES[case]
    data = _frame(1, dtype, shape)
    meta = {**META, **extra}
    j_img = getattr(da, cls)(jnp.asarray(data), **meta)
    t_img = getattr(dt, cls)(data, device="cpu", **meta)
    j_img.save(tmp_path / "jax")
    t_img.save(tmp_path / "torch.npz")
    # The port reads the JAX package's file ...
    t_read = dt.imread(tmp_path / "jax.npz", device="cpu")
    assert np.array_equal(t_read.img.numpy(), data) and t_read.img.device.type == "cpu"
    _same_metadata(t_read, j_img)
    # ... and its own; the JAX package reads the port's.
    t_own = dt.imread(tmp_path / "torch.npz", device="cpu")
    assert np.array_equal(t_own.img.numpy(), data)
    _same_metadata(t_own, j_img)
    j_read = da.imread(tmp_path / "torch.npz")
    assert np.array_equal(np.asarray(j_read.img), data)
    _same_metadata(t_img, j_read)
    if cls == "OpticalImage":
        assert t_read.color_space == j_read.color_space == "RGB"


def test_port_files_hold_plain_values_only(tmp_path):
    """Every metadata value of the port's file is a plain numpy or Python
    value: the stock unpickler reads it with no package at hand."""
    img = dt.OpticalImage(_frame(2), device="cpu", date=datetime.datetime(2024, 1, 1), **META)
    img.save(tmp_path / "img")
    with np.load(tmp_path / "img.npz", allow_pickle=True) as data:
        metadata = data["metadata"][0]
        assert str(data["image_class"]) == "OpticalImage"
    for value in metadata.values():
        module = type(value).__module__
        assert module in ("builtins", "numpy", "datetime"), (type(value), module)
    assert type(metadata["origin"]) is np.ndarray


def test_imread_overrides_and_transformations(tmp_path):
    data = _frame(3, np.uint8)
    da.OpticalImage(jnp.asarray(data), **META).save(tmp_path / "jax")
    shift = dt.TranslationCorrection([1.0, -2.0])
    t_read = dt.imread(tmp_path / "jax.npz", transformations=[shift], name="renamed", device="cpu")
    want = dt.OpticalImage(data, transformations=[shift], device="cpu", **META)
    assert t_read.name == "renamed" and torch.equal(t_read.img, want.img)
    j_read = da.imread(tmp_path / "jax.npz", transformations=[da.TranslationCorrection([1.0, -2.0])])
    assert np.abs(t_read.img.numpy().astype(int) - np.asarray(j_read.img).astype(int)).max() <= 1


def test_imread_numpy_files_lists_and_folders_against_jax(tmp_path):
    frames = [_frame(k, shape=(H, W)) for k in range(3)]
    folder = tmp_path / "frames"
    folder.mkdir()
    for k, frame in enumerate(frames):
        np.save(folder / f"f{k}.npy", frame)
    single_t = dt.imread(folder / "f1.npy", device="cpu", scalar=True, **META)
    single_j = da.imread(folder / "f1.npy", scalar=True, **META)
    assert np.array_equal(single_t.img.numpy(), np.asarray(single_j.img))
    _same_metadata(single_t, single_j)
    paths = [folder / f"f{k}.npy" for k in range(3)]
    for source in (paths, folder, [folder]):
        kw = {"scalar": True, "time": [0.0, 1.0, 2.0], **META}
        t_series = dt.imread(source, device="cpu", **kw)
        j_series = da.imread(source, **kw)
        assert t_series.series and t_series.img.shape == (H, W, 3)
        assert np.array_equal(t_series.img.numpy(), np.asarray(j_series.img))
        _same_metadata(t_series, j_series)
    # In-memory arrays.
    t_mem = dt.imread_from_numpy(frames[0], device="cpu", scalar=True)
    assert np.array_equal(t_mem.img.numpy(), frames[0])
    t_mem = dt.imread_from_numpy(frames[:2], device="cpu", scalar=True, time=[0.0, 1.0])
    assert t_mem.series and t_mem.img.shape == (H, W, 2)


def test_imread_default_device_is_the_card(tmp_path):
    dt.ScalarImage(_frame(4, shape=(H, W)), device="cpu").save(tmp_path / "img")
    if torch.cuda.is_available():
        assert dt.imread(tmp_path / "img.npz").img.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.imread(tmp_path / "img.npz")


@pytest.mark.parametrize(
    "suffix,decoder,error",
    [
        (".jpg", "cv2", ImportError),
        (".PNG", "cv2", ImportError),
        (".tif", "cv2", ImportError),
        (".dcm", "pydicom", ImportError),
        (".vtu", "meshio", ImportError),
    ],
)
def test_imread_names_the_missing_decoder(suffix, decoder, error, tmp_path, monkeypatch):
    """Photographs decode through OpenCV, DICOM through pydicom and VTU
    through meshio, each imported when read: where it does not import, the
    read names it."""
    monkeypatch.setitem(sys.modules, decoder, None)
    path = tmp_path / f"file{suffix}"
    path.write_bytes(b"\0")
    with pytest.raises(error, match=decoder):
        dt.imread(path, device="cpu")


def test_imread_refuses_missing_and_unknown_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        dt.imread(tmp_path / "none.npz", device="cpu")
    (tmp_path / "file.xyz").write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match=".xyz"):
        dt.imread(tmp_path / "file.xyz", device="cpu")


# ----------------------------------------------------------- the npz reader


def test_load_npz_reads_what_numpy_reads(tmp_path):
    rng = np.random.default_rng(5)
    arrays = {
        "f32": rng.random((4, 5)).astype(np.float32),
        "fortran": np.asfortranarray(rng.random((3, 4))),
        "i64": np.arange(6).reshape(2, 3),
        "scalar": np.float64(2.5),
        "flag": np.bool_(True),
        "text": "ColorCorrection",
        "empty": np.array([]),
        "state": np.array([{"a": 1, "b": np.arange(3), "c": [slice(1, 4), None]}], dtype=object),
    }
    for save, name in ((np.savez, "plain"), (np.savez_compressed, "packed")):
        save(tmp_path / name, **arrays)
        got = load_npz(tmp_path / f"{name}.npz")
        with np.load(tmp_path / f"{name}.npz", allow_pickle=True) as want:
            assert set(got) == set(want.files)
            for key in want.files:
                if key == "state":
                    continue
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
                assert np.array_equal(got[key], want[key])
        state = got["state"][0]
        assert state["a"] == 1 and state["c"] == [slice(1, 4), None]
        assert np.array_equal(state["b"], np.arange(3))
    assert set(load_npz(tmp_path / "plain.npz", names=("text", "nothing"))) == {"text"}
    with pytest.raises(FileNotFoundError):
        load_npz(tmp_path / "none.npz")


def test_load_npz_maps_points_and_refuses_other_package_classes(tmp_path):
    points = {
        "origin": da.Coordinate([0.5, 1.5]),
        "voxels": da.make_voxel([[1, 2], [3, 4]]),
        "centers": da.make_voxel_center([[1, 2], [3, 4]]),
    }
    np.savez(tmp_path / "points", metadata=np.array([points], dtype=object))
    got = load_npz(tmp_path / "points.npz")["metadata"][0]
    assert type(got["origin"]) is dt.Coordinate
    assert type(got["voxels"]) is dt.VoxelArray and type(got["centers"]) is dt.VoxelCenterArray
    for key, value in points.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(value))
    # Any other class of the JAX package is refused, not imported.
    np.savez(tmp_path / "checker", metadata=np.array([da.ColorCheckerAfter2014()], dtype=object))
    with pytest.raises(pickle.UnpicklingError, match="darsia_tpu"):
        load_npz(tmp_path / "checker.npz")


# -------------------------------------------- patchwise illumination by path


def test_patchwise_illumination_takes_paths(tmp_path):
    """Saved images in place of images (JAX: patchwiseilluminationcorrection.py
    reads a path with OpenCV; the port reads npz and npy files)."""
    rng = np.random.default_rng(6)
    image = _frame(7)
    baselines = [np.clip(image * (0.8 + 0.4 * rng.random()), 0, 1).astype(np.float32) for _ in range(2)]
    dt.OpticalImage(image, device="cpu", **META).save(tmp_path / "image")
    paths = []
    for k, b in enumerate(baselines):
        da.OpticalImage(jnp.asarray(b), **META).save(tmp_path / f"base{k}")
        paths.append(tmp_path / f"base{k}.npz")
    kw = {"nw": 16, "limit": 8}
    # A path is read onto the card, as every numpy input is; without one
    # the files are read onto the CPU explicitly.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.PatchwiseIlluminationCorrection(tmp_path / "image.npz", paths, **kw)
    read = [dt.imread(p, device="cpu") for p in [tmp_path / "image.npz", *paths]]
    from_files = dt.PatchwiseIlluminationCorrection(read[0], read[1:], **kw)
    from_arrays = dt.PatchwiseIlluminationCorrection(
        torch.from_numpy(image), [torch.from_numpy(b) for b in baselines], **kw
    )
    assert np.array_equal(from_files.correction_grid, from_arrays.correction_grid)
    j = da.PatchwiseIlluminationCorrection(image, baselines, **kw)
    assert np.abs(from_files.correction_grid - np.asarray(j.correction_grid)).max() <= 1e-5
