"""The port's optimal-transport examples against the JAX package's, on the
CPU.

Each case runs the JAX example (a shimmed copy, ``tests/
torch_examples_common.py``) and the port's ``main(device="cpu",
fast=True)`` and compares their labelled lines within the tolerances of
``darsia_tpu_torch/examples/expected.json``; the JAX lines must equal that
file's.  ``wasserstein_split_square`` (a 200-iteration Newton solve at
80x80 in each package) and ``distances`` (OpenCV's EMD on 4096-point
signatures, minutes in each package) are marked slow, as the JAX suite
marks them.
"""

import pytest
import torch
from torch_examples_common import check_example

torch.set_num_threads(1)

TRANSPORT = [
    "wasserstein",
    "sharded_wasserstein",
    pytest.param("wasserstein_split_square", marks=pytest.mark.slow),
    pytest.param("distances", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name", TRANSPORT)
def test_transport_example_matches_jax(name, tmp_path):
    check_example(name, tmp_path, timeout=900)


def test_distances_without_its_emd_matches_the_jax_lines():
    # The W1 half of ``distances`` in tier-1 (the slow case above runs both
    # packages with the EMD): held to the JAX lines with the EMD line left out.
    from darsia_tpu_torch import examples
    from darsia_tpu_torch.examples import distances

    spec = examples.spec("distances")
    spec["lines"] = [line for line in spec["lines"] if not line.startswith("EMD (cv2)")]
    result = distances.main(device="cpu", fast=True, emd=False)
    assert result["emd"] is None
    assert examples.compare_lines(result["lines"], spec) == []
