"""The device-parity sweep on the card: every case of
``tests/torch_device_cases.py`` runs on ``cpu`` and on ``cuda:0``.

Each case's outputs agree within its stated tolerance (a warping case at the
two-pass tier: K1's two passes on the card, the gather warp on the CPU);
every tensor and image a card case returns lies on ``cuda:0``; each K1 call
is copied at the wrapper and held bitwise to the plain K1 on its inputs; the
K1 launches equal the case's count.  A case whose library does not import
raises the ImportError naming it on both devices.  Needs a CUDA card
(marked ``gpu``; skipped elsewhere); imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_device_cases.py
"""

import pytest
import torch
from torch_device_cases import CASES, card_parity

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]


@pytest.fixture(scope="module")
def w2p():
    from darsia_tpu_torch.ops import warp2pass

    warp2pass.build_kernel()
    return warp2pass


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_the_card_equals_the_cpu(w2p, name):
    result = card_parity(CASES[name], w2p)
    assert not result["faults"], "\n".join(result["faults"])
