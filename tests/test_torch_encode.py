"""The port's image writers and encoder against the JAX package's.

``OpticalImage.write``/``encode`` and ``ScalarImage.write`` to png, jpg and
tif of both packages give equal bytes on the same arrays (uint8 and float,
which both clip to [0, 1] and scale to uint8; JPEG quality 90 and PNG
compression 6 by default, or as given).  Both encode with OpenCV on the
host, so the files are byte for byte the same.  The port's images lie on
the CPU here; a card image's encoding is ``tests/test_torch_gpu.py``'s.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)


def _rgb(dtype):
    rng = np.random.default_rng(3)
    arr = rng.random((37, 58, 3))
    arr[5:15, 5:25] = [0.9, 0.1, 0.4]
    arr[20:30, 30:50] = [1.4, -0.2, 0.5]  # clipped by both
    if dtype == "uint8":
        return (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr.astype(np.float32)


def _pair(cls_name, arr):
    port = getattr(dt, cls_name)(torch.from_numpy(arr), width=1.5, height=1.0)
    jax = getattr(da, cls_name)(arr, width=1.5, height=1.0)
    return port, jax


CASES = [
    (".jpg", {}),
    (".jpg", {"quality": 75}),
    (".png", {}),
    (".png", {"compression": 3}),
    (".tif", {}),
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("suffix,kwargs", CASES)
def test_optical_encode_and_write(suffix, kwargs, dtype, tmp_path):
    port, jax = _pair("OpticalImage", _rgb(dtype))
    encoded = port.encode(suffix, **kwargs)
    assert isinstance(encoded, bytes) and encoded == jax.encode(suffix, **kwargs)
    assert port.encode(suffix.lstrip("."), **kwargs) == encoded
    port.write(tmp_path / "port" / f"a{suffix}", **kwargs)
    jax.write(tmp_path / "jax" / f"a{suffix}", **kwargs)
    assert (tmp_path / "port" / f"a{suffix}").read_bytes() == (tmp_path / "jax" / f"a{suffix}").read_bytes()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("suffix,kwargs", [(".png", {}), (".jpg", {}), (".jpg", {"quality": 60}), (".tif", {})])
def test_scalar_write(suffix, kwargs, dtype, tmp_path):
    port, jax = _pair("ScalarImage", _rgb(dtype)[..., 1].copy())
    port.write(tmp_path / f"p{suffix}", **kwargs)
    jax.write(tmp_path / f"j{suffix}", **kwargs)
    assert (tmp_path / f"p{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()


def test_png_round_trip_and_failures(tmp_path, monkeypatch):
    arr = _rgb("uint8")
    port, jax = _pair("OpticalImage", arr)
    back = cv2.imdecode(np.frombuffer(port.encode(".png"), np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(back[..., ::-1], arr)
    for image in (port, jax):
        with pytest.raises(cv2.error):
            image.encode(".xyz")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        port.encode(".png")
    with pytest.raises(ImportError, match="cv2"):
        dt.ScalarImage(torch.zeros(4, 5)).write(tmp_path / "s.png")
