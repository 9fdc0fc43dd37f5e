"""K2 and K3 (the untransposed row resample) against the JAX package.

On the CPU the port's ``warp_rows`` runs its plain PyTorch version,
``warp_rows_reference``, for both schedules; the JAX side runs
``warp_rows_pallas`` in interpret mode on the plain (``ring=False``) and the
ring-buffer (``ring=True``) schedule, as ``tests/unit/test_pallas_warp.py``
does.  The CUDA kernels themselves are tested against the plain version in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darsia_tpu.ops.pallas.warp2pass import warp_rows_pallas
from darsia_tpu_torch.ops import warp2pass
from darsia_tpu_torch.utils import tracing

torch.set_num_threads(1)

# (R, W_in, D, W_out): the three shapes of test_row_warp_schedules_bitwise_equal,
# a ragged case (W_out < W_in, W_out not a multiple of 128) and a case whose
# displacements violate the bound (W_out > W_in, cols scaled by 1.5).
CASES = [
    (64, 300, 7, None),
    (130, 515, 40, None),
    (96, 257, 121, None),
    (33, 200, 3, 150),
    (40, 90, 2, 300),
]


def _rows_case(R, W_in, D, W_out=None, seed=7):
    rng = np.random.default_rng(seed)
    W_out = W_out or W_in
    data = rng.standard_normal((R, W_in)).astype(np.float32)
    jj = np.broadcast_to(np.arange(W_out, dtype=np.float32), (R, W_out))
    cols = (jj + rng.uniform(-D, D, (R, W_out))).astype(np.float32)
    if W_out > W_in:
        cols = cols * np.float32(1.5)  # displacements far beyond D
    return data, cols


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("R,W_in,D,W_out", CASES)
def test_plain_k2_k3_match_pallas_interpret(R, W_in, D, W_out, ring):
    data, cols = _rows_case(R, W_in, D, W_out)
    ref = np.asarray(warp_rows_pallas(jnp.asarray(data), jnp.asarray(cols), D, ring))
    out = warp2pass.warp_rows(torch.from_numpy(data), torch.from_numpy(cols), D, ring)
    assert out.shape == ref.shape == cols.shape
    # Same index arithmetic, so the same samples and fractions; XLA:CPU
    # contracts the interpret-mode lerp into an FMA, which the port (and its
    # CUDA kernels) do not: about 1 ulp apart.  Bound: 1e-6.
    assert np.abs(out.numpy() - ref).max() <= 1e-6


def test_bound_violation_clamps_to_the_chain_edge():
    """Beyond the bound the result is the window chain's edge value, as in
    the Pallas kernel, not the exact sample."""
    data, cols = _rows_case(40, 90, 2, 300)
    data_t, cols_t = torch.from_numpy(data), torch.from_numpy(cols)
    out = warp2pass.warp_rows_reference(data_t, cols_t, 2)
    exact = np.take_along_axis(data, np.clip(np.floor(cols), 0, 89).astype(int), 1)
    assert np.abs(out.numpy() - exact).max() > 0.1


@pytest.mark.parametrize("R,W_in,D,W_out", CASES)
def test_plain_k2_is_plain_k1_transposed(R, W_in, D, W_out):
    """Channels folded into rows with ``cols`` shared across channels: K2's
    plain version equals the swapaxes of K1's, bit for bit."""
    rng = np.random.default_rng(11)
    data = torch.from_numpy(rng.standard_normal((3, R, W_in)).astype(np.float32))
    cols = torch.from_numpy(_rows_case(R, W_in, D, W_out)[1])
    k1 = warp2pass.warp_rows_t_reference(data, cols, D)
    k2 = warp2pass.warp_rows_reference(data.reshape(3 * R, W_in), cols.repeat(3, 1), D)
    assert torch.equal(k2.reshape(3, R, -1), k1.transpose(1, 2))


@pytest.mark.parametrize("ring", [False, True])
def test_cpu_tensor_takes_plain_version_and_counts_nothing(ring):
    data, cols = (torch.from_numpy(a) for a in _rows_case(32, 200, 7))
    before = (tracing.counter("k2.launches"), tracing.counter("k3.launches"))
    out = warp2pass.warp_rows(data, cols, 7, ring=ring)
    assert torch.equal(out, warp2pass.warp_rows_reference(data, cols, 7))
    assert (tracing.counter("k2.launches"), tracing.counter("k3.launches")) == before


def test_wrapper_rejects_bad_input():
    data = torch.zeros((8, 16))
    with pytest.raises(ValueError):
        warp2pass.warp_rows(data, torch.zeros((9, 16)), 4)
    with pytest.raises(ValueError):
        warp2pass.warp_rows(data[None], torch.zeros((8, 16)), 4)
    with pytest.raises(TypeError):
        warp2pass.warp_rows(data.double(), torch.zeros((8, 16)), 4)
    with pytest.raises(ValueError):
        warp2pass.warp_rows(data, torch.zeros((8, 16)), 4, impl="fast")
