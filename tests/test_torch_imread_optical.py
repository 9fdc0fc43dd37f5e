"""The port's photograph reader against the JAX package's.

Both packages read the same files, written by OpenCV in one folder: JPEG,
PNG and TIFF, each alone and as a series (a list and a folder), with the
default transfer and with ``transfer="yuv420"``, and PNG and JPEG bytes
through ``imread_from_bytes``.  The decode is OpenCV's in both, so the
default reads are bitwise equal, and so are the metadata.  A ``yuv420``
read is bitwise the port's reconstruction of OpenCV's planes, and within
``tests/test_torch_transfer.py``'s bound of the JAX package's yuv420 read:
1 uint8 level on at most 0.1% of the values (the two bilinear upsamples
round their float32 weights differently).  The comparison runs on one
machine (one OpenCV build); the port reads on the CPU (``device="cpu"``).
"""

import datetime

import cv2
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu_torch.utils.transfer import reconstruct_rgb_yuv420, split_rgb_yuv420

torch.set_num_threads(1)

SUFFIXES = [".jpg", ".png", ".tif"]
META_KEYS = ["color_space", "date", "dimensions", "indexing", "name", "origin", "scalar", "series", "space_dim", "time"]


def _photo(h, w, seed):
    """Smooth content with a sharp painted square, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    chans = [0.5 + 0.4 * np.sin((3 + k) * xx + k) * np.cos((2 + k) * yy) for k in range(3)]
    rgb = (np.stack(chans, -1) * 255).astype(np.uint8)
    rgb[h // 4 : h // 2, w // 3 : w // 2] = rng.integers(0, 256, 3, dtype=np.uint8)
    return rgb


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("optical")
    for k in range(3):
        rgb = _photo(45, 71, k)
        for suffix in SUFFIXES:
            sub = root / suffix[1:]
            sub.mkdir(exist_ok=True)
            cv2.imwrite(str(sub / f"img_{k}{suffix}"), rgb[..., ::-1].copy())
    return root


def _same_meta(port, jax):
    pm, jm = port.metadata(), jax.metadata()
    for key in META_KEYS:
        a, b = pm[key], jm[key]
        if key in ("origin", "dimensions"):
            assert np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0, atol=1e-12), key
        else:
            assert a == b, key


def _assert_within_transfer_bound(got: np.ndarray, want: np.ndarray):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_single_photograph_bitwise(folder, suffix):
    path = folder / suffix[1:] / f"img_0{suffix}"
    kw = {"width": 2.0, "height": 1.2}
    port = dt.imread(path, device="cpu", **kw)
    jax = da.imread(path, **kw)
    assert type(port).__name__ == type(jax).__name__ == "OpticalImage"
    assert port.img.device.type == "cpu" and port.img.dtype == torch.uint8
    assert np.array_equal(port.img.numpy(), np.asarray(jax.img))
    # OpenCV's own read, converted to RGB.
    assert np.array_equal(port.img.numpy(), cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    _same_meta(port, jax)


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_series_from_a_list_and_a_folder(folder, suffix):
    paths = sorted((folder / suffix[1:]).glob(f"*{suffix}"))
    times = [0.0, 60.0, 120.0]
    port = dt.imread(paths, device="cpu", time=times)
    jax = da.imread(paths, time=times)
    assert port.series and port.img.shape == (45, 71, 3, 3)
    assert np.array_equal(port.img.numpy(), np.asarray(jax.img))
    _same_meta(port, jax)
    from_folder = dt.imread(folder / suffix[1:], device="cpu", time=times)
    assert np.array_equal(from_folder.img.numpy(), port.img.numpy())


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_yuv420_reads(folder, suffix):
    path = folder / suffix[1:] / f"img_1{suffix}"
    port = dt.imread(path, device="cpu", transfer="yuv420")
    jax = da.imread(path, transfer="yuv420")
    rgb = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    planes = split_rgb_yuv420(rgb)
    assert np.array_equal(port.img.numpy(), reconstruct_rgb_yuv420(*planes, device="cpu").numpy())
    _assert_within_transfer_bound(port.img.numpy(), np.asarray(jax.img))
    _same_meta(port, jax)
    paths = sorted((folder / suffix[1:]).glob(f"*{suffix}"))
    series = dt.imread(paths, device="cpu", transfer="yuv420")
    jax_series = da.imread(paths, transfer="yuv420")
    assert series.img.shape == (45, 71, 3, 3) and series.img.device.type == "cpu"
    assert np.array_equal(series.img[:, :, 1].numpy(), port.img.numpy())
    _assert_within_transfer_bound(series.img.numpy(), np.asarray(jax_series.img))


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
def test_imread_from_bytes(suffix):
    rgb = _photo(33, 50, 4)
    ok, buf = cv2.imencode(suffix, rgb[..., ::-1].copy())
    assert ok
    data = bytes(buf.tobytes())
    port = dt.imread_from_bytes(data, device="cpu", width=1.0, height=1.0)
    jax = da.imread_from_bytes(data, width=1.0, height=1.0)
    assert type(port).__name__ == "OpticalImage"
    assert np.array_equal(port.img.numpy(), np.asarray(jax.img))
    _same_meta(port, jax)
    gray = rgb[..., 0].copy()
    ok, buf = cv2.imencode(".png", gray)
    port = dt.imread_from_bytes(bytes(buf.tobytes()), device="cpu")
    jax = da.imread_from_bytes(bytes(buf.tobytes()))
    assert type(port).__name__ == "ScalarImage" and np.array_equal(port.img.numpy(), np.asarray(jax.img))
    with pytest.raises(ValueError, match="decode"):
        dt.imread_from_bytes(b"not an image", device="cpu")


def test_exif_date_is_read_as_by_the_jax_package(tmp_path):
    from PIL import Image as PILImage

    path = tmp_path / "dated.jpg"
    exif = PILImage.Exif()
    exif[306] = "2024:05:06 07:08:09"  # DateTime
    PILImage.fromarray(_photo(20, 30, 5)).save(path, exif=exif)
    port = dt.imread(path, device="cpu")
    jax = da.imread(path)
    assert port.date == jax.date == datetime.datetime(2024, 5, 6, 7, 8, 9)
    assert np.array_equal(port.img.numpy(), np.asarray(jax.img))


def test_broken_and_missing_photographs(tmp_path):
    (tmp_path / "broken.png").write_bytes(b"\0\1\2")
    with pytest.raises(ValueError, match="Could not read"):
        dt.imread(tmp_path / "broken.png", device="cpu")
    with pytest.raises(FileNotFoundError):
        dt.imread(tmp_path / "none.jpg", device="cpu")


def test_photographs_go_to_the_card_by_default(folder):
    from unittest import mock

    path = folder / "png" / "img_0.png"
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        for kw in ({}, {"transfer": "yuv420"}):
            with pytest.raises(RuntimeError, match="CUDA"):
                dt.imread(path, **kw)
