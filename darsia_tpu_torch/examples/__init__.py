"""The JAX package's example suite, written for the port.

One module per script of the JAX package's ``examples/``, of the same name.
Each has ``main(device=None, fast=False) -> dict``: it runs on ``device``
(the CUDA card when None; without a card it raises, naming
``device="cpu"``), prints the JAX example's labelled lines in the same
format and returns them under ``"lines"``, with the numbers it printed.
``fast`` is the JAX suite's ``DARSIA_TPU_FAST=1`` (smaller inputs, fewer
levels).  Data comes to the host through :func:`~..image.image.as_numpy`;
reductions run on the tensor (``t.min()``, not ``np.min(t)``, which a CUDA
tensor refuses).

Run one::

    python -m darsia_tpu_torch.examples.wasserstein              # on the card
    python -m darsia_tpu_torch.examples.wasserstein --device cpu --fast

``expected.json`` holds the JAX examples' fast-mode lines with each
example's tolerances, and the default-mode lines of ``fused_pipeline``,
``image_registration`` and ``co2_and_tracer_analysis`` (the examples whose
default mode differs, the two Newton transport ones aside;
``color_correction`` and ``optical_images`` take no fast mode);
:func:`spec` gives what a run is held to and :func:`compare_lines` holds it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
from pathlib import Path

__all__ = [
    "EXAMPLES",
    "Report",
    "cli",
    "compare_lines",
    "expected",
    "masked",
    "missing_library",
    "run",
    "spec",
]

# In the order they were ported: paths that reach K1 first.
EXAMPLES = (
    "fused_pipeline",
    "image_registration",
    "color_correction",
    "co2_analysis",
    "co2_and_tracer_analysis",
    "phase_segmentation",
    "kernel_interpolation",
    "regularization",
    "reading_images",
    "readme_example",
    "optical_images",
    "numpy_images",
    "segmentation",
    "dicom_images",
    "vtu_images",
    "wasserstein",
    "wasserstein_split_square",
    "distances",
    "sharded_wasserstein",
)

EXPECTED = Path(__file__).with_name("expected.json")

_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?\binf\b|\bnan\b")


class Report:
    """``print`` that keeps each line: ``report(*parts)`` prints the parts
    as ``print`` would and appends the line to ``report.lines``."""

    def __init__(self) -> None:
        self.lines: list[str] = []

    def __call__(self, *parts) -> None:
        line = " ".join(str(p) for p in parts)
        print(line)
        self.lines.append(line)


def missing_library(err: ImportError, library: str) -> str:
    """The message of ``err`` when it names ``library`` (a step that needs a
    library the host lacks); any other ImportError is raised again."""
    message = str(err)
    if library not in message:
        raise err
    return message


def masked(lines: list, spec: dict) -> list:
    """``lines`` with the parts that ``spec["masks"]`` (regular expressions)
    names replaced: what differs from run to run, temporary folders and
    wall times."""
    out = []
    for line in lines:
        for mask in spec.get("masks", []):
            line = re.sub(mask, "<masked>", line)
        out.append(line)
    return out


def _tokens(line: str) -> tuple:
    """(the line with each number replaced by '#', its numbers)."""
    numbers = [float(m.group()) for m in _NUMBER.finditer(line)]
    return _NUMBER.sub("#", line), numbers


def compare_lines(lines: list, spec: dict) -> list:
    """The disagreements of ``lines`` with ``spec["lines"]`` (empty when they
    agree).  Every line's text must be equal; its numbers must agree within
    ``|x - y| <= atol + rtol |y|``: ``spec["rtol"]`` and ``spec["atol"]``,
    or a line's own ``spec["per_line"][label]`` where given (one
    ``{"rtol", "atol"}`` for all its numbers, or a list of them, one per
    number), the label being the text before the first colon.
    ``spec["exempt"]`` lists labels whose values are not compared (type
    names); the parts that ``spec["masks"]`` names are not compared."""
    want = spec["lines"]
    if len(lines) != len(want):
        return [f"{len(lines)} lines, want {len(want)}: {lines} against {want}"]
    default = {"rtol": spec.get("rtol", 1e-5), "atol": spec.get("atol", 0.0)}
    faults = []
    for got, ref in zip(masked(lines, spec), masked(want, spec)):
        label = ref.split(":", 1)[0]
        if label in spec.get("exempt", []):
            if got.split(":", 1)[0] != label:
                faults.append(f"label {got!r}, want {ref!r}")
            continue
        text, numbers = _tokens(got)
        ref_text, ref_numbers = _tokens(ref)
        if text != ref_text or len(numbers) != len(ref_numbers):
            faults.append(f"{got!r} against {ref!r}")
            continue
        tols = spec.get("per_line", {}).get(label, default)
        if isinstance(tols, dict):
            tols = [tols] * len(numbers)
        for x, y, tol in zip(numbers, ref_numbers, tols):
            tol = {**default, **tol}
            if x != y and not abs(x - y) <= tol["atol"] + tol["rtol"] * abs(y):
                faults.append(f"{got!r} against {ref!r}: {x} vs {y} beyond {tol}")
                break
    return faults


def expected() -> dict:
    """``expected.json``: per example, the JAX example's fast-mode lines and
    the tolerances the port is held to (default-mode lines and the card's
    own tolerances under ``"default"`` and ``"card"``: see :func:`spec`)."""
    return json.loads(EXPECTED.read_text())


def spec(name: str, fast: bool = True, card: bool = False) -> dict:
    """What ``main(fast=fast)`` of ``name`` is held to: ``expected.json``'s
    fast-mode entry, or for the default mode its ``"default"`` lines and
    tolerances on top of it (raises where the file pins none); with
    ``card``, the card's own tolerances on top of those."""
    entry = expected()[name]
    out = {key: value for key, value in entry.items() if key not in ("default", "card")}
    layers = []
    if not fast:
        if "default" not in entry:
            raise KeyError(f"expected.json pins no default-mode lines of {name!r}")
        layers.append(entry["default"])
    if card:
        layers.append(entry.get("card", {}))
    for layer in layers:
        out["per_line"] = {**out.get("per_line", {}), **layer.get("per_line", {})}
        if "lines" in layer:
            out["lines"] = layer["lines"]
    return out


def run(name: str, device=None, fast: bool = False) -> dict:
    """``main`` of the example ``name``."""
    if name not in EXAMPLES:
        raise ValueError(f"unknown example {name!r}; the examples are {EXAMPLES}")
    module = importlib.import_module(f"{__name__}.{name}")
    return module.main(device=device, fast=fast)


def cli(main, argv=None) -> dict:
    """The command line of an example: ``--device`` (default: the card) and
    ``--fast``."""
    parser = argparse.ArgumentParser(description=main.__module__)
    parser.add_argument("--device", default=None, help='e.g. "cpu" (default: the CUDA card)')
    parser.add_argument("--fast", action="store_true", help="smaller inputs, as DARSIA_TPU_FAST=1")
    args = parser.parse_args(argv)
    return main(device=args.device, fast=args.fast)
