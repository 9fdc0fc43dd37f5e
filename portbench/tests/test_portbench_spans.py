"""The readers of the program's spans (``portbench/spans.py`` and the ten
metrics that use it): numbers from synthetic span lists, None where there
are no spans, no traced frames or batches, or no CUDA events, and where the
program has no tracing module; then the same readers on the tiny lane and
a tiny batched W1 solve recorded on the CPU."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT, tiny_lane, tiny_w1

from portbench import harness
from portbench import spans as pspans

LANE_HOST = ("correct_host_ms.series8", "register_host_ms.series8", "concentrate_host_ms.series8")
LANE_DEVICE = ("correct_device_ms.live", "register_device_ms.live", "concentrate_device_ms.live")
W1 = ("cg_iters_per_newton.w1", "launches_per_cg_iter.w1", "pressure_share.w1")
NEW = LANE_HOST + ("assemble_host_ms.series8",) + LANE_DEVICE + W1


def reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    return harness.load_module(path, "test_" + name.replace(".", "_"))


class Maker:
    """Synthetic spans in start order, 1 ms of host time a step."""

    def __init__(self, events: bool = True):
        self.spans, self.t, self.events = [], 0, events

    def add(self, name, parent=None, ms=1.0, device_ms=None, counts=None):
        self.t += 1_000_000
        s = SimpleNamespace(
            name=name, id=len(self.spans) + 1, parent=None if parent is None else parent.id,
            start_ns=self.t, end_ns=self.t + int(ms * 1e6), counts=dict(counts or {}),
            device_ms=device_ms if self.events else None,
        )
        self.spans.append(s)
        return s


def lane_spans(calls=2, frames=3, events=True):
    """``calls`` calls of ``frames`` frames; stage k of a frame takes k + 1
    host ms and 0.5 * (k + 1) stream ms, assemble 0.25 ms per call."""
    m = Maker(events)
    for _ in range(calls):
        call = m.add("pipeline.call", ms=100.0, device_ms=50.0)
        for _ in range(frames):
            frame = m.add("pipeline.frame", call, ms=10.0, device_ms=5.0)
            for k, stage in enumerate(("correct", "register", "concentrate")):
                m.add(f"pipeline.{stage}", frame, ms=k + 1.0, device_ms=0.5 * (k + 1),
                      counts={"k1.launches": 2} if k < 2 else None)
        m.add("pipeline.assemble", call, ms=0.25, device_ms=0.1)
    return m.spans


def w1_spans(newton=4, trips=10, events=True):
    """One solve: a Darcy pressure solve, then ``newton`` iterations of one
    pressure solve each; every pressure solve ``trips`` CG trips and 2
    stream ms of the solve's 20."""
    m = Maker(events)
    solve = m.add("beckmann.solve", ms=30.0, device_ms=20.0)
    m.add("beckmann.pressure", solve, device_ms=2.0, counts={"beckmann.cg_trips": trips})
    for _ in range(newton):
        it = m.add("beckmann.newton", solve, device_ms=3.0)
        m.add("beckmann.pressure", it, device_ms=2.0, counts={"beckmann.cg_trips": trips})
    return m.spans


@pytest.fixture
def recorded(monkeypatch):
    holder = {"spans": []}
    monkeypatch.setattr(pspans, "recorded", lambda: holder["spans"])
    return holder


def test_lane_readers_on_synthetic_spans(recorded):
    # A device-only trace of 2 series of 3 frames, then a host trace of one.
    recorded["spans"] = lane_spans(calls=3, frames=3)
    rec = {"trace": {"frames": 6}}
    got = {name: reader(name).read(rec) for name in LANE_HOST + LANE_DEVICE}
    assert got == pytest.approx({
        "correct_host_ms.series8": 1.0, "register_host_ms.series8": 2.0, "concentrate_host_ms.series8": 3.0,
        "correct_device_ms.live": 0.5, "register_device_ms.live": 1.0, "concentrate_device_ms.live": 1.5,
    })
    # Two calls' assemble spans over their six frames.
    assert reader("assemble_host_ms.series8").read(rec) == pytest.approx(2 * 0.25 / 6)


def test_w1_readers_on_synthetic_spans(recorded):
    recorded["spans"] = w1_spans(newton=4, trips=10)
    rec = {"trace": {"batches": 1, "kernel_launches": 5000}}
    assert reader("cg_iters_per_newton.w1").read(rec) == pytest.approx(5 * 10 / 4)
    assert reader("launches_per_cg_iter.w1").read(rec) == pytest.approx(5000 / 50)
    assert reader("pressure_share.w1").read(rec) == pytest.approx(100.0 * 5 * 2.0 / 20.0)


@pytest.mark.parametrize("name", NEW)
def test_no_spans_reads_none(recorded, name):
    rec = {"trace": {"frames": 6, "batches": 1, "kernel_launches": 5000}}
    assert reader(name).read(rec) is None
    recorded["spans"] = None
    assert reader(name).read(rec) is None
    # Spans, but no trace in the record.
    recorded["spans"] = lane_spans() + w1_spans()
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", LANE_DEVICE + ("pressure_share.w1",))
def test_no_cuda_events_reads_none(recorded, name):
    recorded["spans"] = lane_spans(events=False) + w1_spans(events=False)
    assert reader(name).read({"trace": {"frames": 6, "batches": 1, "kernel_launches": 5000}}) is None


@pytest.mark.parametrize("name", LANE_HOST + ("assemble_host_ms.series8",))
def test_fewer_frames_than_traced_reads_none(recorded, name):
    recorded["spans"] = lane_spans(calls=1, frames=3)
    assert reader(name).read({"trace": {"frames": 6}}) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_tracing_reads_none(monkeypatch, name):
    """The parent program has no tracing module: nothing, no exception."""
    import darsia_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "darsia_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(darsia_tpu_torch.utils, "tracing", raising=False)
    assert pspans.recorded() is None
    assert reader(name).read({"trace": {"frames": 6, "batches": 1, "kernel_launches": 5000}}) is None


def test_host_readers_on_the_recorded_tiny_lane():
    """The tiny lane recorded on the CPU: the four host stages of a traced
    series fit inside its calls; the stream readers find no events."""
    from darsia_tpu_torch.utils import tracing

    cell = harness.find_cell("lane4k.series8")
    cfg = tiny_lane(cell.config)
    base, series = cell.program.make_inputs(cfg, 7, torch.device("cpu"), 2, 3)
    pipeline = cell.program.build(cfg, base)
    pipeline(series[0])
    tracing.reset()
    try:
        with tracing.recording():
            for s in series:
                pipeline(s)
        calls = [s for s in tracing.spans() if s.name == "pipeline.call"]
        rec = {"trace": {"frames": 6}}
        parts = [reader(name).read(rec) for name in LANE_HOST + ("assemble_host_ms.series8",)]
        assert all(p is not None and p > 0 for p in parts)
        per_frame = sum(1e-6 * (c.end_ns - c.start_ns) for c in calls) / 6
        assert sum(parts) <= per_frame
        assert all(reader(name).read(rec) is None for name in LANE_DEVICE)
    finally:
        tracing.reset()


def test_w1_counter_readers_on_a_recorded_tiny_solve():
    from darsia_tpu_torch.utils import tracing

    cell = harness.find_cell("w1ff.allpairs")
    cfg = tiny_w1(cell.config)
    cfg["options"] = dict(cfg["options"], num_iter=6)
    [(src, dst)] = cell.program.make_inputs(cfg, 11, torch.device("cpu"), 1, cfg["batch"])
    solve = cell.program.build(cfg)
    tracing.reset()
    try:
        before = tracing.counter("beckmann.cg_trips")
        tic = time.perf_counter()
        with tracing.recording():
            _, iterations, _ = solve(src, dst)
        assert time.perf_counter() - tic < 60
        trips = tracing.counter("beckmann.cg_trips") - before
        rec = {"trace": {"batches": 1, "kernel_launches": 10 * trips}}
        assert reader("cg_iters_per_newton.w1").read(rec) == pytest.approx(trips / int(iterations.max()))
        assert reader("launches_per_cg_iter.w1").read(rec) == pytest.approx(10.0)
        assert reader("pressure_share.w1").read(rec) is None  # no CUDA events on the CPU
    finally:
        tracing.reset()
