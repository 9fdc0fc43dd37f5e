"""``CurvatureCorrection(image=<path>)``: the tuning image read from an npz
or npy file through the port's ``imread``, against the JAX package's
``CurvatureCorrection(image=array)`` on the same data (the tuning steps on
the two images within one uint8 level at 0.1% of the values, as
``tests/test_torch_drift.py`` holds the tuning helpers); other files raise
naming their decoder."""

import sys

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

KW = {"width": 1.5, "height": 1.0}


def _tuning_image() -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 1, 60), np.linspace(0, 1, 90), indexing="ij")
    chans = [0.5 + 0.4 * np.sin(5 * xx + k) * np.cos(4 * yy) for k in range(3)]
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _close_u8(a, b):
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("suffix", [".npy", ".npz"])
def test_tuning_image_from_a_file_against_jax(tmp_path, suffix):
    img = _tuning_image()
    path = tmp_path / f"tuning{suffix}"
    if suffix == ".npy":
        np.save(path, img)
    else:
        dt.OpticalImage(torch.from_numpy(img), **KW).save(path)
    port = dt.CurvatureCorrection(image=path, device="cpu", **KW)
    jax = da.CurvatureCorrection(image=img, **KW)
    assert port.reference_image.device.type == "cpu"
    assert np.array_equal(port.reference_image.numpy(), img)
    assert np.array_equal(port.temporary_image, jax.temporary_image)
    for corr in (jax, port):
        corr.pre_bulge_correction(horizontal_bulge=2e-6, vertical_bulge=-1e-6)
        corr.crop([[3, 4], [57, 2], [58, 88], [2, 86]])
        corr.bulge_correction(left=3, right=1, top=2, bottom=1)
    assert port.config["bulge"] == jax.config["bulge"]
    _close_u8(port.temporary_image, jax.temporary_image)


def test_tuning_image_of_another_format_names_its_decoder(tmp_path, monkeypatch):
    """A photograph decodes through OpenCV: where it does not import, the
    read names it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    path = tmp_path / "tuning.jpg"
    path.write_bytes(b"\xff\xd8")
    with pytest.raises(ImportError, match="cv2"):
        dt.CurvatureCorrection(image=path, device="cpu", **KW)
