"""The reader of ``kernel_trip_share.w1``: the share of the traced solve's
CG trips that the pressure solve's kernels ran, from synthetic span lists;
0 where trips ran but none in the kernels (the tensor CG, as on the CPU);
None where the program has no kernel-trip counter, where there are no spans
or no traced batches, and where the program has no tracing module."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT, tiny_w1

from portbench import harness
from portbench import spans as pspans

NAME = "kernel_trip_share.w1"


def reader():
    path = ROOT / "portbench" / "metrics" / f"{NAME}.py"
    return harness.load_module(path, "test_" + NAME.replace(".", "_"))


def w1_spans(newton=4, trips=10, kernel_trips=(10, 10, 10, 10, 10)):
    """One solve: a Darcy pressure solve, then ``newton`` iterations of one
    pressure solve each; pressure solve k counts ``trips`` CG trips, of them
    ``kernel_trips[k]`` in the kernels (None: the counter is absent)."""
    out = []

    def add(name, parent=None, counts=None):
        s = SimpleNamespace(name=name, id=len(out) + 1, parent=None if parent is None else parent.id,
                            start_ns=len(out), end_ns=len(out) + 1, counts=dict(counts or {}),
                            device_ms=1.0)
        out.append(s)
        return s

    def counts(k):
        c = {"beckmann.cg_trips": trips}
        if kernel_trips[k] is not None:
            c["beckmann.mg_kernel_trips"] = kernel_trips[k]
        return c

    solve = add("beckmann.solve")
    add("beckmann.pressure", solve, counts(0))
    for k in range(newton):
        it = add("beckmann.newton", solve)
        add("beckmann.pressure", it, counts(k + 1))
    return out


@pytest.fixture
def recorded(monkeypatch):
    holder = {"spans": []}
    monkeypatch.setattr(pspans, "recorded", lambda: holder["spans"])
    return holder


REC = {"trace": {"batches": 1, "kernel_launches": 5000}}


@pytest.mark.parametrize(
    "kernel_trips,share",
    [((10, 10, 10, 10, 10), 100.0), ((0, 10, 10, 10, 10), 80.0), ((10, 5, 0, 0, 0), 30.0),
     ((0, 0, 0, 0, 0), 0.0), ((None,) * 5, None)],
    ids=["all", "all but the Darcy start", "some", "none", "a program without the counter"],
)
def test_reads_the_kernel_share_of_synthetic_spans(recorded, kernel_trips, share):
    recorded["spans"] = w1_spans(kernel_trips=kernel_trips)
    got = reader().read(REC)
    assert got == (None if share is None else pytest.approx(share))


def test_counts_only_the_traced_solves(recorded):
    """A second solve after the traced one (the window's, or another
    trace's) is not read."""
    first = w1_spans(kernel_trips=(10, 10, 0, 0, 0))
    second = w1_spans(kernel_trips=(10, 10, 10, 10, 10))
    for s in second:
        s.id += len(first)
        s.parent = None if s.parent is None else s.parent + len(first)
    recorded["spans"] = first + second
    assert reader().read(REC) == pytest.approx(40.0)


def test_no_spans_or_no_trace_reads_none(recorded):
    assert reader().read(REC) is None
    recorded["spans"] = None
    assert reader().read(REC) is None
    recorded["spans"] = w1_spans()
    assert reader().read({}) is None
    assert reader().read({"trace": {"frames": 6}}) is None


def test_a_program_without_tracing_reads_none(monkeypatch):
    import darsia_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "darsia_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(darsia_tpu_torch.utils, "tracing", raising=False)
    assert pspans.recorded() is None
    assert reader().read(REC) is None


def test_a_recorded_tiny_solve_on_the_cpu_reads_zero():
    """On the CPU the pressure solves run the tensor CG: trips, but none in
    the kernels."""
    from darsia_tpu_torch.utils import tracing

    cell = harness.find_cell("w1ff.allpairs")
    cfg = tiny_w1(cell.config)
    cfg["options"] = dict(cfg["options"], num_iter=3)
    [(src, dst)] = cell.program.make_inputs(cfg, 11, torch.device("cpu"), 1, cfg["batch"])
    solve = cell.program.build(cfg)
    tracing.reset()
    try:
        before = tracing.counter("beckmann.cg_trips")
        with tracing.recording():
            solve(src, dst)
        assert tracing.counter("beckmann.cg_trips") > before
        assert reader().read(REC) == 0.0
    finally:
        tracing.reset()
