"""The benchmark's harness: one run of one cell, found by name.

``BENCHMARK.json`` names the cell; its files are found by name:

* ``workloads/<cell>.json``: the traffic mix, whose ``generator`` names
  the loop that drives it, ``generators/<generator>.py``;
* ``configs/<config>.json`` (the configuration as run) and
  ``configs/<config>.py`` (its inputs from the seed, and the program built
  from it);
* ``reference/<config>.py``: the plain reference the generator compares the
  timed path's answers with;
* ``metrics/<metric>.py``: one reader per metric, ``read(rec)`` -> a number
  or None, from the record the generator returns.

A generator's ``run(cell, seed, seconds, trace, device, t0)`` makes the inputs,
builds the program, warms up, measures for ``seconds``, reads the peak
memory, frees the program and compares; it returns the record.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "darsia_tpu")


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mod_name(kind: str, name: str) -> str:
    return "portbench_" + kind + "_" + name.replace(".", "_").replace("-", "_")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic: dict
    config: dict
    end_to_end: list
    per_layer: list
    bench: Path = BENCH
    modules: dict = field(default_factory=dict)

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of the benchmark, imported once."""
        key = (kind, name)
        if key not in self.modules:
            self.modules[key] = load_module(self.bench / kind / f"{name}.py", _mod_name(kind, name))
        return self.modules[key]

    @property
    def program(self):
        return self.module("configs", self.config_name)

    @property
    def reference(self):
        return self.module("reference", self.config_name)

    @property
    def generator(self):
        return self.module("generators", self.traffic["generator"])

    def reader(self, metric: str):
        return self.module("metrics", metric)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH) -> Cell:
    spec = json.loads(Path(bench_json).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic=json.loads((bench / "workloads" / f"{name}.json").read_text()),
        config=json.loads((bench.parent / cfg_entry["file"]).read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench=bench,
    )


class NoCard(RuntimeError):
    pass


def card(chips: int):
    """The first CUDA device, after checking that ``chips`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda:0")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """The generator's record of one run, with what the readers need besides."""
    import torch

    import gc

    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    rec = cell.generator.run(cell, seed, seconds, trace, device, t0)
    rec["config"] = cell.config
    rec["device_kind"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return rec


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``darsia_tpu_torch`` is not ``darsia_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def metrics_of(cell: Cell, rec: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    metrics (``trace`` true), each read by its own reader; a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, rec: dict, trace: bool) -> dict:
    check = rec["check"]
    device = {
        "platform": "gpu",
        "kind": rec["device_kind"],
        "count": cell.chips,
        "memory_peak_bytes": int(rec["memory_peak_bytes"]),
    }
    line = {
        "correct": bool(check["correct"]),
        "attempted": int(rec["attempted"]),
        "failed": int(check["failed"]),
        "metrics": metrics_of(cell, rec, trace),
        "device": device,
    }
    if trace:
        tr = rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:10]],
        }
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in check["numbers"].items()}
    return line


def main(args, t0: float) -> int:
    """Run ``args.workload`` once; print the result line last on stdout."""
    try:
        cell = find_cell(args.workload)
    except (KeyError, FileNotFoundError) as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    try:
        device = card(cell.chips)
    except NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port may not use: {found}", file=sys.stderr)
        return 4
    line = result_line(cell, rec, bool(args.trace))
    from portbench.common import now, power_limit

    print(f"portbench: card {power_limit()}", file=sys.stderr)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in rec.get("setup_parts", {}).items())
    print(f"portbench: set-up seconds since start: {parts}", file=sys.stderr)
    print(
        f"portbench: window {rec['window_s']:.3f} s, comparison {rec['check']['seconds']:.3f} s, "
        f"run {now() - t0:.3f} s",
        file=sys.stderr,
    )
    for note in rec.get("notes", []):
        print(f"portbench: {note}", file=sys.stderr)
    print(f"portbench: no module named {', '.join(FORBIDDEN)} loaded", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k} = {v['value']!r}, limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
