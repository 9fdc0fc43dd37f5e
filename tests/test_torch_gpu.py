"""K1, the hand-written CUDA kernel, against its plain PyTorch version.

Needs a CUDA card (marked ``gpu``; skipped elsewhere).  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from darsia_tpu_torch.ops import warp2pass
from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]


def _rows_case(C, R, W_in, D, W_out=None, seed=7):
    rng = np.random.default_rng(seed)
    W_out = W_out or W_in
    data = rng.standard_normal((C, R, W_in)).astype(np.float32)
    jj = np.broadcast_to(np.arange(W_out, dtype=np.float32), (R, W_out))
    cols = (jj + rng.uniform(-D, D, (R, W_out))).astype(np.float32)
    return torch.from_numpy(data).cuda(), torch.from_numpy(cols).cuda()


@pytest.mark.parametrize(
    "C,R,W_in,D,W_out",
    [
        (3, 64, 300, 7, None),
        (3, 130, 515, 40, None),
        (3, 96, 257, 121, None),
        (1, 33, 200, 3, 150),  # ragged tiles, C = 1, W_out < W_in
        (2, 40, 90, 2, 300),  # bound violated: chain-edge clamp
    ],
)
def test_kernel_matches_plain(C, R, W_in, D, W_out):
    data, cols = _rows_case(C, R, W_in, D, W_out)
    if W_out == 300:
        cols = cols * 1.5  # displacements far beyond D
    before = warp2pass.launch_count
    out = warp2pass.warp_rows_t(data, cols, D)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 1
    ref = warp2pass.warp_rows_t_reference(data, cols, D)
    assert out.shape == ref.shape == (C, cols.shape[1], R)
    assert (out - ref).abs().max().item() <= 1e-6
    # Same index arithmetic and a lerp without FMA on both sides: bitwise.
    assert torch.equal(out, ref)
    assert warp2pass.launch_count == before + 1


def test_plain_impl_on_cuda_counts_no_launch():
    data, cols = _rows_case(3, 64, 300, 7)
    before = warp2pass.launch_count
    out = warp2pass.warp_rows_t(data, cols, 7, impl="plain")
    assert out.is_cuda and warp2pass.launch_count == before


def test_kernel_refuses_noncontiguous_input():
    data, cols = _rows_case(3, 64, 300, 7)
    with pytest.raises(ValueError):
        warp2pass.warp_rows_t(data, cols.t().contiguous().t(), 7)


def test_two_pass_warp_on_cuda_matches_cpu_plain():
    rng = np.random.default_rng(3)
    H, W = 150, 210
    img = rng.random((H, W, 3)).astype(np.float32)
    coords = identity_grid((H, W), "cpu") + torch.from_numpy(
        (2.0 * np.sin(np.arange(H * W).reshape(1, H, W) / 53.0)).astype(np.float32)
    )
    cpu = warp_backend(torch.from_numpy(img), coords, max_disp=4, force="kernel")
    before = warp2pass.launch_count
    gpu = warp_backend(torch.from_numpy(img).cuda(), coords.cuda(), max_disp=4)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 2
    assert (gpu.cpu() - cpu).abs().max().item() <= 1e-6
