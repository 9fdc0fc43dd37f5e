"""The port's analysis examples against the JAX package's, on the CPU.

Each case runs the JAX example (a shimmed copy, ``tests/
torch_examples_common.py``) and the port's ``main(device="cpu",
fast=True)`` and compares their labelled lines within the tolerances of
``darsia_tpu_torch/examples/expected.json``; the JAX lines must equal that
file's.  On the CPU the warps are the gather warp, as in the JAX package
off the TPU.
"""

import pytest
import torch
from torch_examples_common import check_example

torch.set_num_threads(1)

ANALYSIS = [
    "fused_pipeline",
    "image_registration",
    "color_correction",
    "co2_analysis",
    "co2_and_tracer_analysis",
    "phase_segmentation",
]


@pytest.mark.parametrize("name", ANALYSIS)
def test_analysis_example_matches_jax(name, tmp_path):
    check_example(name, tmp_path)
