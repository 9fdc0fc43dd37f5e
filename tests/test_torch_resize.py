"""``ops/resize.py``: every method name ``jax.image.resize`` takes and the
n-D linear resampling, against the JAX package.

The same seeded float32 data goes through ``darsia_tpu.ops.resize`` and
``darsia_tpu_torch.ops.resize`` on the CPU.  The port builds the JAX
resampling matrices in float32 and contracts one axis at a time (JAX: one
einsum), so results agree to float32 rounding: within 2e-6 of data in
[0, 1] (Lanczos and cubic weights are negative in places, so an output may
sum a few more rounded terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darsia_tpu.ops.resize import resize_array as jax_resize_array
from darsia_tpu.ops.resize import upsample_linear as jax_upsample_linear
from darsia_tpu_torch.ops.resize import resize_array, upsample_linear

torch.set_num_threads(1)

TOL = 2e-6

METHODS = [
    "nearest",
    "linear",
    "bilinear",
    "trilinear",
    "triangle",
    "cubic",
    "bicubic",
    "tricubic",
    "lanczos3",
    "lanczos5",
]


def _data(shape, seed=3):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "shape,target",
    [
        ((40, 56), (17, 23)),  # shrink: antialiased
        ((17, 23), (40, 56)),  # grow
        ((48, 64), (12, 16)),  # integer shrink ("linear" alone takes the block mean)
        ((30, 40), (45, 20)),  # one axis grows, one shrinks: no antialias
    ],
)
def test_every_jax_method_name_matches(method, shape, target):
    data = _data(shape + (2,))
    got = resize_array(torch.from_numpy(data), target, method)
    want = np.asarray(jax_resize_array(jnp.asarray(data), target, method))
    assert got.shape == want.shape == target + (2,)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("method", ["bilinear", "tricubic", "lanczos3", "lanczos5"])
def test_three_axes_and_conservative(method):
    data = _data((12, 10, 14))
    target = (7, 15, 9)
    got = resize_array(torch.from_numpy(data), target, method, conservative=True)
    want = np.asarray(jax_resize_array(jnp.asarray(data), target, method, conservative=True))
    scale = np.prod(data.shape) / np.prod(target)
    assert np.abs(got.numpy() - want).max() <= TOL * scale


def test_unknown_method_raises_as_in_jax():
    data = _data((8, 8))
    with pytest.raises(ValueError, match="Unknown resize method"):
        jax_resize_array(jnp.asarray(data), (4, 5), "lanczos7")
    with pytest.raises(ValueError, match="Unknown resize method"):
        resize_array(torch.from_numpy(data), (4, 5), "lanczos7")


@pytest.mark.parametrize(
    "shape,target",
    [
        ((9,), (20,)),  # 1-D
        ((6, 7, 5), (11, 13, 9)),  # 3-D
        ((6, 7, 2), (11, 13)),  # 2-D, a trailing channel axis
        ((20, 24), (9, 30)),  # a shrinking axis: antialiased
        ((12, 10, 14, 2), (7, 15, 9)),  # 3-D down and up, a channel axis
    ],
)
def test_upsample_linear_takes_any_leading_axes(shape, target):
    data = _data(shape, seed=11)
    got = upsample_linear(torch.from_numpy(data), target)
    want = np.asarray(jax_upsample_linear(jnp.asarray(data), target))
    assert got.shape == want.shape == tuple(target) + shape[len(target) :]
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL
