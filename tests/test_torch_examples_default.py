"""The port's examples in their default mode against the JAX package's, on
the CPU.

``fused_pipeline`` and ``image_registration`` are the examples on K1's path
whose default mode differs from fast mode (270x512 frames and 4x8 patches,
256x384 frames and 8x12 patches); ``color_correction`` and
``optical_images``, the other two on K1's path, read no fast switch, so
their default mode is the fast mode's run, pinned as such;
``co2_and_tracer_analysis`` runs its TVD to its default cap at 180x340;
``sharded_wasserstein`` solves at 64x64 over 8 shards and
``wasserstein_split_square`` at 160x160 (about 25 and 45 s of JAX, 17 and
90 s of the port on this CPU).  Every example whose default mode differs
from its fast mode is pinned.  Each case runs the JAX example
without ``DARSIA_TPU_FAST`` (a shimmed copy, ``tests/
torch_examples_common.py``) and the port's ``main(device="cpu",
fast=False)``, and compares their lines within the tolerances of
``expected.json``'s ``"default"`` entry; the JAX lines must equal it.
"""

import pytest
import torch
from torch_examples_common import check_example

from darsia_tpu_torch import examples

torch.set_num_threads(1)

DEFAULT = [
    "fused_pipeline",
    "image_registration",
    "co2_and_tracer_analysis",
    "color_correction",
    "optical_images",
    "sharded_wasserstein",
    "wasserstein_split_square",
]


@pytest.mark.parametrize("name", DEFAULT)
def test_default_mode_example_matches_jax(name, tmp_path):
    check_example(name, tmp_path, fast=False)


def test_default_mode_lines_are_pinned_for_these_examples_only():
    table = examples.expected()
    assert sorted(name for name, entry in table.items() if "default" in entry) == sorted(DEFAULT)


def test_spec_layers_default_mode_and_card_tolerances():
    table = examples.expected()
    fast = examples.spec("fused_pipeline")
    assert fast["lines"] == table["fused_pipeline"]["lines"]
    assert "default" not in fast and "card" not in fast
    default = examples.spec("fused_pipeline", fast=False)
    assert default["lines"] == table["fused_pipeline"]["default"]["lines"]
    assert default["per_line"]["displacement field"] == {"rtol": 1e-4}
    card = examples.spec("optical_images", card=True)
    assert card["per_line"]["hsv range"] == table["optical_images"]["card"]["per_line"]["hsv range"]
    assert "hsv range" not in examples.spec("optical_images").get("per_line", {})
    with pytest.raises(KeyError, match="default-mode"):
        examples.spec("wasserstein", fast=False)
