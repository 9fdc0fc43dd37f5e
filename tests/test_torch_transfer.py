"""The port's YUV420 transfer path against OpenCV and the JAX package.

``split_rgb_yuv420`` calls OpenCV in both packages (``RGB2YCrCb`` and
``INTER_AREA``): the port's planes are bitwise the JAX package's, odd
shapes included (so within the 1 uint8 level the test's name states).  ``reconstruct_rgb_yuv420`` runs in PyTorch (here on the CPU)
against the JAX package's jitted reconstruction on the same planes: within
1 uint8 level (the two bilinear upsamples round their float32 weights
differently) and equal on at least 99.9% of the values.
"""

import numpy as np
import pytest
import torch

from darsia_tpu.utils.transfer import reconstruct_rgb_yuv420 as jax_reconstruct
from darsia_tpu.utils.transfer import split_rgb_yuv420 as cv2_split
from darsia_tpu_torch.utils.transfer import (
    put_rgb_yuv420,
    reconstruct_rgb_yuv420,
    split_rgb_yuv420,
)

torch.set_num_threads(1)

SHAPES = [(240, 320), (101, 50), (123, 77), (7, 3), (1, 1), (2, 5)]


def _photo_like(h, w, seed=0):
    """Smooth 'photograph' content: low-frequency fields per channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    chans = []
    for k in range(3):
        a, b, c = rng.uniform(0.5, 2.0, 3)
        f = 0.5 + 0.4 * np.sin(a * 4 * xx + k) * np.cos(b * 3 * yy) + 0.05 * c
        chans.append(np.clip(f, 0, 1))
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _frame(kind, h, w, seed):
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return _photo_like(h, w, seed)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_within_one_level_of_cv2(shape, kind):
    rgb = _frame(kind, *shape, seed=sum(shape))
    ours = split_rgb_yuv420(rgb)
    theirs = cv2_split(rgb)
    assert [p.shape for p in ours] == [p.shape for p in theirs]
    assert ours[1].shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.uint8
        assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_reconstruction_matches_the_jax_package(shape):
    import jax.numpy as jnp

    y, cr, cb = cv2_split(_photo_like(*shape, seed=7))
    want = np.asarray(jax_reconstruct(jnp.asarray(y), jnp.asarray(cr), jnp.asarray(cb)))
    got = reconstruct_rgb_yuv420(y, cr, cb, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_roundtrip_on_photo_content():
    rgb = _photo_like(240, 320)
    out = put_rgb_yuv420(rgb, device="cpu").numpy()
    assert out.shape == rgb.shape and out.dtype == np.uint8
    err = np.abs(out.astype(np.float32) - rgb.astype(np.float32))
    assert err.mean() < 1.0 and np.percentile(err, 99) <= 4.0


def test_tensor_planes_stay_on_their_device():
    y, cr, cb = (torch.from_numpy(p) for p in split_rgb_yuv420(_photo_like(33, 20)))
    out = reconstruct_rgb_yuv420(y, cr, cb, out_dtype=np.float32)
    assert out.device.type == "cpu" and out.dtype == torch.float32 and out.shape == (33, 20, 3)


def test_numpy_planes_default_to_the_card():
    from unittest import mock

    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            put_rgb_yuv420(_photo_like(8, 8))
