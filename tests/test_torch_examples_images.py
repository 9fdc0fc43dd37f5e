"""The port's image examples against the JAX package's, on the CPU.

Each case runs the JAX example (a shimmed copy, ``tests/
torch_examples_common.py``) and the port's ``main(device="cpu",
fast=True)``, and compares their labelled lines within the tolerances of
``darsia_tpu_torch/examples/expected.json``; the JAX lines must equal that
file's.  Also: every example raises without a card when no device is named,
and an example runs from the command line.
"""

import subprocess
import sys

import pytest
import torch
from torch_examples_common import REPO, check_example

from darsia_tpu_torch import examples

torch.set_num_threads(1)

IMAGES = [
    "reading_images",
    "readme_example",
    "optical_images",
    "numpy_images",
    "segmentation",
    "dicom_images",
    "vtu_images",
    "regularization",
    "kernel_interpolation",
]


@pytest.mark.parametrize("name", IMAGES)
def test_image_example_matches_jax(name, tmp_path):
    check_example(name, tmp_path)


def test_every_jax_example_has_a_port_and_expected_lines():
    jax_names = sorted(p.stem for p in (REPO / "examples").glob("*.py") if not p.name.startswith("_"))
    assert sorted(examples.EXAMPLES) == jax_names
    table = examples.expected()
    assert sorted(table) == jax_names
    for name in jax_names:
        assert table[name]["lines"], name
        assert (REPO / "darsia_tpu_torch" / "examples" / f"{name}.py").exists(), name


@pytest.mark.parametrize("name", examples.EXAMPLES)
def test_example_without_a_card_raises_naming_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        examples.run(name)


def test_example_runs_from_the_command_line():
    result = subprocess.run(
        [sys.executable, "-m", "darsia_tpu_torch.examples.numpy_images", "--device", "cpu", "--fast"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.splitlines() == examples.expected()["numpy_images"]["lines"]


def test_compare_lines_holds_text_numbers_and_tolerances():
    spec = {"lines": ["a: 1.0 (2, 3)", "t: x"], "rtol": 1e-5, "exempt": ["t"], "masks": [r" in \S+s"]}
    assert examples.compare_lines(["a: 1.000001 (2, 3)", "t: y"], spec) == []
    assert examples.compare_lines(["a: 1.0001 (2, 3)", "t: y"], spec)
    assert examples.compare_lines(["a: 1.0 (2, 4)", "t: y"], spec)
    assert examples.compare_lines(["b: 1.0 (2, 3)", "t: y"], spec)
    assert examples.compare_lines(["a: 1.0 (2, 3)"], spec)
    per = {**spec, "per_line": {"a": [{"rtol": 0.1}, {"atol": 1}, {"rtol": 0.0}]}}
    assert examples.compare_lines(["a: 1.05 (3, 3)", "t: y"], per) == []
    assert examples.compare_lines(["a: 1.05 (3, 4)", "t: y"], per)
    timed = {"lines": ["W1 0.5 in 1.23s, 200 iterations"], "masks": [r" in \d+\.\d+s,"]}
    assert examples.compare_lines(["W1 0.5 in 99.00s, 200 iterations"], timed) == []
