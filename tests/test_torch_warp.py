"""The port's gather warp and coordinate-field helpers against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darsia_tpu.ops import warp as jw
from darsia_tpu_torch.ops import warp as tw

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _field(shape, seed, amp=3.0, spill=0.0):
    rng = np.random.default_rng(seed)
    ident = np.asarray(jw.identity_grid(shape))
    noise = rng.uniform(-amp, amp, (2, 1, 1)) + 0.7 * np.sin(
        np.arange(np.prod(shape)).reshape((1,) + shape) / 11.0
    )
    scale = np.array(shape, dtype=float).reshape(2, 1, 1) * spill
    return (ident + noise + scale).astype(np.float32)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("mode", ["constant", "nearest"])
@pytest.mark.parametrize("channels", [0, 3])
def test_gather_warp_matches_jax(order, mode, channels):
    rng = np.random.default_rng(order * 10 + channels)
    shape = (31, 45)
    data = rng.random(shape + ((channels,) if channels else ())).astype(np.float32)
    # Out-of-domain samples on one side exercise the fill / clamp.
    coords = _field((27, 40), seed=channels, spill=0.05)
    ref = np.asarray(jw.warp(jnp.asarray(data), jnp.asarray(coords), order=order, mode=mode))
    out = tw.warp(torch.from_numpy(data), torch.from_numpy(coords), order=order, mode=mode)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_compose_coordinate_maps_matches_jax():
    outer = _field((20, 30), seed=1)
    inner = _field((24, 33), seed=2)
    ref = np.asarray(jw.compose_coordinate_maps(jnp.asarray(outer), jnp.asarray(inner)))
    out = tw.compose_coordinate_maps(torch.from_numpy(outer), torch.from_numpy(inner))
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_perspective_grid_matches_jax():
    H = np.array([[1.02, 0.01, -1.5], [-0.02, 0.98, 2.0], [1e-4, -2e-4, 1.0]])
    ref = np.asarray(jw.perspective_grid(jnp.asarray(H, jnp.float32), (25, 37)))
    out = tw.perspective_grid(torch.as_tensor(H, dtype=torch.float32), (25, 37))
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_warp_backend_on_cpu_is_the_gather_warp():
    data = np.random.default_rng(3).random((20, 30, 3)).astype(np.float32)
    coords = _field((20, 30), seed=4)
    a = tw.warp_backend(torch.from_numpy(data), torch.from_numpy(coords), max_disp=5)
    b = tw.warp(torch.from_numpy(data), torch.from_numpy(coords))
    assert torch.equal(a, b)
    ref = np.asarray(jw.warp_backend(jnp.asarray(data), jnp.asarray(coords), max_disp=5))
    assert np.abs(a.numpy() - ref).max() <= 1e-5
