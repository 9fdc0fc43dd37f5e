"""K1 (the two-pass warp's row kernel) and its wrappers against the JAX package.

On the CPU the port's ``warp_rows_t`` runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as ``tests/unit/
test_pallas_warp.py`` does.  The CUDA kernel itself is tested against the
plain version in ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from darsia_tpu.ops.pallas.warp2pass import warp_rows_pallas_t
from darsia_tpu.ops.pallas.warp2pass import warp_two_pass as jax_warp_two_pass
from darsia_tpu.ops.warp import identity_grid as jax_identity_grid
from darsia_tpu.ops.warp import warp_backend as jax_warp_backend
from darsia_tpu_torch.ops import warp2pass
from darsia_tpu_torch.utils import tracing
from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

torch.set_num_threads(1)

# (R, W, D) of test_row_warp_schedules_bitwise_equal.
SCHEDULE_SHAPES = [(64, 300, 7), (130, 515, 40), (96, 257, 121)]


def _rows_case(R, W, D, seed=7):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((3, R, W)).astype(np.float32)
    jj = np.broadcast_to(np.arange(W, dtype=np.float32), (R, W))
    cols = (jj + rng.uniform(-D, D, (R, W))).astype(np.float32)
    return data, cols


@pytest.mark.parametrize("R,W,D", SCHEDULE_SHAPES)
def test_plain_k1_matches_pallas_interpret(R, W, D):
    data, cols = _rows_case(R, W, D)
    ref = np.asarray(warp_rows_pallas_t(jnp.asarray(data), jnp.asarray(cols), D))
    out = warp2pass.warp_rows_t(torch.from_numpy(data), torch.from_numpy(cols), D)
    assert out.shape == ref.shape
    # Same index arithmetic, so the same samples and fractions; XLA:CPU
    # contracts the interpret-mode lerp into an FMA, which the port (and its
    # CUDA kernel) do not, so the two differ by a rounding of the product
    # (about 1 ulp).  Bound: 1e-6.
    assert np.abs(out.numpy() - ref).max() <= 1e-6


def test_plain_k1_chain_edge_when_bound_is_violated():
    """Displacements beyond the bound clamp to the window-chain edge, as in
    the Pallas kernel (not the exact gather)."""
    R, W, D = 40, 300, 3
    data, _ = _rows_case(R, W, D, seed=3)
    rng = np.random.default_rng(4)
    jj = np.broadcast_to(np.arange(W, dtype=np.float32), (R, W))
    cols = (jj + rng.uniform(-60, 60, (R, W))).astype(np.float32)
    ref = np.asarray(warp_rows_pallas_t(jnp.asarray(data), jnp.asarray(cols), D))
    out = warp2pass.warp_rows_t(torch.from_numpy(data), torch.from_numpy(cols), D)
    assert np.abs(out.numpy() - ref).max() <= 1e-6
    exact = np.take_along_axis(
        data, np.broadcast_to(np.clip(np.floor(cols), 0, W - 1).astype(int), data.shape), 2
    )
    assert np.abs(out.numpy() - np.swapaxes(exact, 1, 2)).max() > 0.1


def _sine_grid(H, W, OH=None, OW=None, amp=2.0):
    OH, OW = OH or H, OW or W
    disp = amp * np.sin(np.arange(OH * OW).reshape(1, OH, OW) / 53.0)
    return np.asarray(jax_identity_grid((OH, OW))) + disp.astype(np.float32)


@pytest.mark.parametrize(
    "H,W,C,OH,OW",
    [(64, 96, 3, 64, 96), (64, 96, 0, 64, 96), (70, 90, 3, 60, 90), (50, 80, 2, 58, 80)],
)
def test_warp_two_pass_matches_jax(H, W, C, OH, OW):
    rng = np.random.default_rng(17)
    shape = (H, W, C) if C else (H, W)
    img = rng.random(shape).astype(np.float32)
    grid = _sine_grid(H, W, OH, OW).astype(np.float32)
    ref = np.asarray(jax_warp_two_pass(jnp.asarray(img), jnp.asarray(grid), 4))
    out = warp2pass.warp_two_pass(torch.from_numpy(img), torch.from_numpy(grid), 4)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-6


def test_warp_backend_kernel_matches_jax_pallas():
    rng = np.random.default_rng(5)
    h, w = 48, 64
    img = rng.random((h, w, 3)).astype(np.float32)
    coords = np.asarray(jax_identity_grid((h, w))) + np.stack(
        [np.full((h, w), 1.3, np.float32), np.full((h, w), -2.1, np.float32)]
    )
    ref = np.asarray(
        jax_warp_backend(
            jnp.asarray(img), jnp.asarray(coords), order=1, max_disp=4, force="pallas"
        )
    )
    out = warp_backend(
        torch.from_numpy(img), torch.from_numpy(coords), order=1, max_disp=4, force="kernel"
    )
    assert np.abs(out.numpy() - ref).max() <= 1e-6
    gather = warp_backend(
        torch.from_numpy(img), torch.from_numpy(coords), order=1, force="gather"
    )
    assert np.abs(out.numpy() - gather.numpy()).max() < 1e-4


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    data, cols = _rows_case(32, 200, 7)
    before = tracing.counter("k1.launches")
    out = warp2pass.warp_rows_t(torch.from_numpy(data), torch.from_numpy(cols), 7)
    ref = warp2pass.warp_rows_t_reference(torch.from_numpy(data), torch.from_numpy(cols), 7)
    assert torch.equal(out, ref)
    assert tracing.counter("k1.launches") == before


def test_wrapper_rejects_bad_input():
    data = torch.zeros((3, 8, 16))
    with pytest.raises(ValueError):
        warp2pass.warp_rows_t(data, torch.zeros((9, 16)), 4)
    with pytest.raises(TypeError):
        warp2pass.warp_rows_t(data.double(), torch.zeros((8, 16)), 4)
    with pytest.raises(ValueError):
        warp2pass.warp_rows_t(data, torch.zeros((8, 16)), 4, impl="fast")


def test_kernel_index_range_guard():
    """K1 offsets channel planes in 64 bits and indexes within a plane in 32:
    a plane (input or output) of 2**31 elements or more is refused."""
    warp2pass._check_index_range("warp_rows_t", 2**31 - 1, 5)
    with pytest.raises(ValueError, match="32-bit"):
        warp2pass._check_index_range("warp_rows_t", 3, 2**31)


def test_identity_grid_matches_jax():
    ref = np.asarray(jax_identity_grid((5, 7)))
    assert np.array_equal(identity_grid((5, 7), torch.device("cpu")).numpy(), ref)

