"""The harness finds a cell added as files alone, refuses to run without a
card, and a run loads no JAX and no JAX package."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, tiny_lane

from portbench import harness


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(
        {"name": "lane4k.series2", "config": "ff_lane_4k", "traffic": "series2", "chips": 1,
         "why": "two-frame series"}
    )
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "lane4k.series8" in m.get("workloads", []):
            m["workloads"].append("lane4k.series2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((bench / "workloads" / "lane4k.series8.json").read_text())
    traffic.update(series_length=2, pool_series=2, check_calls=2)
    (bench / "workloads" / "lane4k.series2.json").write_text(json.dumps(traffic))

    cell = harness.find_cell("lane4k.series2", tmp_path / "BENCHMARK.json", bench)
    assert cell.traffic["series_length"] == 2 and cell.program.__file__.startswith(str(bench))
    cell.config = tiny_lane(cell.config)
    rec = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    line = harness.result_line(cell, rec, False)
    assert line["correct"] and rec["frames"] % 2 == 0
    assert {"frames_per_s", "setup_s"} <= set(line["metrics"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no.such.cell")


def test_forbidden_names_are_compared_whole(monkeypatch):
    import darsia_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "darsia_tpu.ops", sys)
    assert harness.forbidden_modules() == ["darsia_tpu"]


_RUN_ON_CPU = """
import sys, time, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_lane, tiny_w1
from portbench import harness
for name, tiny in (("lane4k.series8", tiny_lane), ("lane4k.live", tiny_lane), ("w1ff.allpairs", tiny_w1)):
    cell = harness.find_cell(name)
    cell.config = tiny(cell.config)
    if name.startswith("w1"):
        cell.traffic = dict(cell.traffic, check_pairs=1)
    rec = harness.run_cell(cell, 3, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert rec["check"]["correct"], name
print(harness.forbidden_modules())
"""


def test_a_run_imports_no_jax():
    code = _RUN_ON_CPU.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "lane4k.series8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
