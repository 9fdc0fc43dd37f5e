"""The faults the device-parity sweep found in the port, each against the
JAX package on the CPU (ROADMAP Queue 3, port-side P3 on).

P3: ``full_like(image, data)`` built a new image from ``data`` without the
image's device, so a numpy array went to the CUDA card (and raised without
one) while the image lay on the CPU.  It copies the image and assigns the
data, as the JAX package does: the result lies on the image's device and
equals the JAX package's bitwise (the data are copied, not computed).
"""

import numpy as np
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)


def test_full_like_keeps_the_image_device_and_equals_jax():
    rng = np.random.default_rng(0)
    base = rng.random((12, 16)).astype(np.float32)
    data = rng.random((12, 16)).astype(np.float32)
    meta = {"width": 1.6, "height": 1.2}
    port = dt.full_like(dt.ScalarImage(torch.from_numpy(base), **meta), data)
    jax = da.full_like(da.ScalarImage(base, **meta), data)
    assert port.img.device.type == "cpu"
    np.testing.assert_array_equal(port.img.numpy(), np.asarray(jax.img))
    assert port.dimensions == list(jax.dimensions) and np.array_equal(port.origin, np.asarray(jax.origin))
    tensor = torch.from_numpy(data)
    assert dt.full_like(dt.ScalarImage(torch.from_numpy(base), **meta), tensor).img is tensor
