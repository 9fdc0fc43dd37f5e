"""``BENCHMARK.json`` against the benchmark's contract: names, units, keys,
sources, the metrics each cell reports, the files each entry is found by,
and the length of a full check."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH_CHARS.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (ROOT / path).is_dir()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert "assumed" in data and "limits" in data
        for kind in ("configs", "reference"):
            assert (BENCH / kind / f"{c['name']}.py").is_file()


def test_workloads():
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    configs = {c["name"] for c in SPEC["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        traffic = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "generators" / f"{traffic['generator']}.py").is_file()


def test_metrics_keys_sources_and_readers():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names and 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in names
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_what_it_must():
    e2e = SPEC["end_to_end"]
    for w in SPEC["workloads"]:
        cell = w["name"]
        own = [m["name"] for m in e2e if _applies(m, cell)]
        assert "setup_s" in own and len(own) >= 2, cell
        assert any(_applies(m, cell) for m in SPEC["per_layer"]), cell


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", cells):
            assert _applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_layer_names_are_used_consistently():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("portbench/_cache"):
            continue
        assert PATH_CHARS.match(rel), rel
        assert NAME.match(path.name), rel
