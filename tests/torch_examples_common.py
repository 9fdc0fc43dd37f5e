"""Shared by ``tests/test_torch_examples_*.py``: run a JAX example and its
port, and hold each against ``darsia_tpu_torch/examples/expected.json``.

The JAX examples run from a copy in a temporary folder, as
``tests/integration/test_examples.py`` runs them (``_run_example.py`` on
the CPU, ``DARSIA_TPU_FAST=1``, 8 virtual devices), with one change: the
copy's ``_data.py`` builds ``OpticalImage`` where the JAX file builds a
plain ``Image`` (reference fault 1), and the copy of ``optical_images.py``
takes that image where the JAX file calls the undefined ``to_optical``.
So both packages see the same input class.  No JAX file is edited.

Run as a script to rewrite the ``lines`` of ``expected.json`` (fast mode,
and the default mode where the file pins it) from the live JAX examples
(the tolerances stay)::

    python tests/torch_examples_common.py [name ...]
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from darsia_tpu_torch import examples  # noqa: E402

EXAMPLES_DIR = REPO / "examples"
RUNNER = REPO / "tests" / "integration" / "_run_example.py"

# (file, JAX text, shimmed text): the copy's only changes.
SHIMS = (
    ("_data.py", '    return da.Image(data, width=2.8, height=1.5, color_space="RGB")',
     '    return da.OpticalImage(data, width=2.8, height=1.5, color_space="RGB")'),
    ("_data.py", "        img = da.Image(\n", "        img = da.OpticalImage(\n"),
    ("optical_images.py", "load_baseline(shape=(270, 512)).to_optical()", "load_baseline(shape=(270, 512))"),
)


def shimmed_examples(folder: Path) -> Path:
    """A copy of the JAX examples in ``folder`` with the input-class shim."""
    for path in EXAMPLES_DIR.glob("*.py"):
        shutil.copy(path, folder / path.name)
    for name, old, new in SHIMS:
        path = folder / name
        text = path.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: the shimmed line {old!r} is not there once")
        path.write_text(text.replace(old, new))
    return folder


def run_jax_example(folder: Path, name: str, timeout: float, fast: bool = True) -> list:
    """The stdout lines of the JAX example ``name`` run from ``folder``, in
    fast mode (``DARSIA_TPU_FAST=1``) or its default mode."""
    env = dict(os.environ)
    env.pop("DARSIA_TPU_FAST", None)
    env.update(
        MPLBACKEND="Agg",
        PYTHONPATH=str(REPO),
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        TMPDIR=str(folder),
    )
    if fast:
        env["DARSIA_TPU_FAST"] = "1"
    result = subprocess.run(
        [sys.executable, str(RUNNER), str(folder / f"{name}.py")],
        cwd=folder,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if result.returncode != 0:
        raise AssertionError(
            f"JAX {name} failed (rc={result.returncode})\n"
            f"stdout:\n{result.stdout[-2000:]}\nstderr:\n{result.stderr[-2000:]}"
        )
    return result.stdout.splitlines()


def run_port_example(name: str, workdir: Path, fast: bool = True) -> dict:
    """``main(device="cpu", fast=fast)`` of the port's ``name``, its
    temporary folders under ``workdir``, its stdout kept apart."""
    saved = tempfile.tempdir
    tempfile.tempdir = str(workdir)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            result = examples.run(name, device="cpu", fast=fast)
    finally:
        tempfile.tempdir = saved
    if out.getvalue().splitlines() != result["lines"]:
        raise AssertionError(f"{name}: printed {out.getvalue()!r}, returned {result['lines']}")
    return result


def check_example(name: str, tmp_path: Path, timeout: float = 420, fast: bool = True) -> None:
    """The JAX example prints ``expected.json``'s lines (masked parts
    aside), and the port prints them within the stated tolerances; in fast
    mode or, where the file pins its lines, the default mode."""
    torch.set_num_threads(1)
    spec = examples.spec(name, fast=fast)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_lines = run_jax_example(shimmed_examples(jax_dir), name, timeout, fast)
    assert examples.masked(jax_lines, spec) == examples.masked(spec["lines"], spec), (
        f"{name}: expected.json is stale\nlive JAX: {jax_lines}\nexpected: {spec['lines']}"
    )
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    result = run_port_example(name, port_dir, fast)
    faults = examples.compare_lines(result["lines"], {**spec, "lines": jax_lines})
    assert not faults, f"{name}: the port disagrees with the JAX example:\n" + "\n".join(faults)


def rewrite_expected(names: list) -> None:
    """Rewrite the ``lines`` of ``names`` in ``expected.json`` from live JAX
    runs, fast mode and, where the file pins it, the default mode."""
    table = examples.expected()
    with tempfile.TemporaryDirectory() as tmp:
        folder = shimmed_examples(Path(tmp))
        for name in names:
            table[name]["lines"] = run_jax_example(folder, name, timeout=900)
            print(name, table[name]["lines"])
            if "default" in table[name]:
                table[name]["default"]["lines"] = run_jax_example(folder, name, timeout=900, fast=False)
                print(name, "default mode", table[name]["default"]["lines"])
    examples.EXPECTED.write_text(json.dumps(table, indent=1) + "\n")


if __name__ == "__main__":
    rewrite_expected(sys.argv[1:] or list(examples.EXAMPLES))
