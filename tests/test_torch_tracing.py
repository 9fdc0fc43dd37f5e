"""The port's spans and counters (``darsia_tpu_torch/utils/tracing.py``).

Off, a span is one shared object that reads no clock and makes no CUDA
event; on (``recording()`` or a running profiler), the two-warp lane of
``test_torch_pipeline.py`` and a small batched W1 solve leave the span tree
and counts that the benchmark's readers take apart, and the profiler's
exported trace carries the same names.
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_pipeline import _base_u8, _objects

import darsia_tpu_torch as dt
from darsia_tpu_torch.measure import beckmann_kernels as tbk
from darsia_tpu_torch.parallel import batched_wasserstein
from darsia_tpu_torch.utils import tracing
from darsia_tpu_torch.utils.prefetch import prefetch_map

torch.set_num_threads(1)

STAGES = ("pipeline.correct", "pipeline.register", "pipeline.concentrate")
W1_GRID = (16, 24)
W1_OPTIONS = {"num_iter": 40, "tol_distance": 1e-4}


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def lane():
    base = _base_u8()
    objs = _objects(dt, dt.Jacobi, base, torch.from_numpy)
    probes = [np.roll(base, shift=(1 + k, 2), axis=(0, 1)) for k in range(3)]
    series = torch.from_numpy(np.stack(probes, axis=2))  # (H, W, T, C)
    return {"pipe": objs["pipe"], "frame": torch.from_numpy(probes[0]), "series": series}


def _w1_batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    H, W = W1_GRID
    src = np.zeros((B, H, W))
    dst = np.zeros((B, H, W))
    for b in range(B):
        src[b, 3:7, 3 + b : 8 + b] = 1
        dst[b, 8 + b % 3 : 13, 12:18] = 1
    src = src + 0.02 * rng.random(src.shape)
    dst = dst + 0.02 * rng.random(dst.shape)
    cell = (1.0 / W) ** 2
    src /= src.sum(axis=(1, 2), keepdims=True) * cell
    dst /= dst.sum(axis=(1, 2), keepdims=True) * cell
    return torch.from_numpy(src.astype(np.float32)), torch.from_numpy(dst.astype(np.float32))


def _children(spans, parent, name=None):
    return [s for s in spans if s.parent == parent.id and (name is None or s.name == name)]


def _under(spans, root):
    """``root`` and every span below it."""
    out, ids = [root], {root.id}
    for s in spans:  # start order: a parent opens before its children
        if s.parent in ids:
            out.append(s)
            ids.add(s.id)
    return out


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


# ------------------------------------------------------------------ off


def test_off_span_is_one_shared_object_and_records_nothing():
    assert not tracing.enabled()
    a = tracing.span("a")
    b = tracing.span("b", device="cpu", frames=3)
    assert a is b
    with a as inner:
        with b:
            tracing.count("tests.off")
    assert inner is a
    assert tracing.spans() == []


def test_off_lane_and_w1_read_no_clock_and_make_no_event(lane, monkeypatch):
    """With tracing off a span reads no clock and creates no CUDA event,
    on the lane and in a batched W1 solve; nothing is recorded."""

    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("a span read the clock with tracing off")

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was created with tracing off")

    monkeypatch.setattr(tracing, "time", NoClock())
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    before = tracing.counter("beckmann.cg_trips")
    lane["pipe"](lane["series"])
    lane["pipe"](lane["frame"])
    src, dst = _w1_batch(B=2)
    batched_wasserstein(W1_GRID, 1.0 / W1_GRID[1], None, W1_OPTIONS)(src, dst)
    assert tracing.spans() == []
    assert tracing.counter("beckmann.cg_trips") > before  # counters stay on


def _count_host_reads(monkeypatch):
    """Count the tensor methods that read a value on the host."""
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "__bool__"):
        original = getattr(torch.Tensor, name)

        def wrapped(self, *args, _original=original, **kwargs):
            reads["n"] += 1
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return reads


def test_tracing_adds_no_host_read(lane, monkeypatch):
    """The lane and a batched W1 solve read the same values on the host
    with tracing on as off: the spans and the CG trip count read nothing
    from the device."""
    src, dst = _w1_batch(B=2)
    solve = batched_wasserstein(W1_GRID, 1.0 / W1_GRID[1], None, W1_OPTIONS)
    lane["pipe"](lane["series"])  # built before counting
    reads = _count_host_reads(monkeypatch)
    per_mode = []
    for on in (False, True):
        reads["n"] = 0
        if on:
            tracing.enable()
        lane["pipe"](lane["series"])
        solve(src, dst)
        tracing.disable()
        per_mode.append(reads["n"])
    assert per_mode[0] == per_mode[1] > 0


# ------------------------------------------------------------------ the lane


def test_recording_the_lane_gives_the_stage_tree(lane):
    with tracing.recording():
        lane["pipe"](lane["series"])
        lane["pipe"](lane["frame"])
    assert not tracing.enabled()
    spans = tracing.spans()
    calls = [s for s in spans if s.name == "pipeline.call"]
    assert [c.attrs["frames"] for c in calls] == [3, 1]
    assert all(c.parent is None for c in calls)
    for call, frames in zip(calls, (3, 1)):
        got = _children(spans, call, "pipeline.frame")
        assert len(got) == frames
        [assemble] = _children(spans, call, "pipeline.assemble")
        assert _within(assemble, call) and assemble.start_ns >= got[-1].end_ns
        for frame in got:
            assert _within(frame, call)
            stages = _children(spans, frame)
            assert [s.name for s in stages] == list(STAGES)
            for s in stages:
                assert _within(s, frame) and s.host_ms >= 0.0
                assert s.device_ms is None  # CPU: no CUDA events
            assert sum(s.host_ms for s in stages) <= frame.host_ms
    ids = [s.id for s in spans]
    assert len(set(ids)) == len(ids)
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)


def test_a_new_frame_signature_counts_one_build(lane):
    pipe = dt.FusedAnalysisPipeline(
        transformations=lane["pipe"].transformations,
        registration=lane["pipe"].registration,
        analysis=lane["pipe"].analysis,
    )
    before = tracing.counter("pipeline.builds")
    with tracing.recording():
        pipe(lane["frame"])
        pipe(lane["frame"])
        pipe(lane["series"])  # same frame signature: no new build
    assert tracing.counter("pipeline.builds") == before + 1
    builds = [s for s in tracing.spans() if s.name == "pipeline.build"]
    assert len(builds) == 1 and builds[0].counts == {"pipeline.builds": 1}
    first_call = next(s for s in tracing.spans() if s.name == "pipeline.call")
    assert builds[0].parent == first_call.id


def test_profiler_exports_the_spans_as_user_annotations(lane, tmp_path):
    lane["pipe"](lane["frame"])  # built outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        lane["pipe"](lane["series"])
    assert not tracing.enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            names[e["name"]] = names.get(e["name"], 0) + 1
    want = {"pipeline.call": 1, "pipeline.frame": 3, "pipeline.assemble": 1}
    want.update(dict.fromkeys(STAGES, 3))
    assert {k: names.get(k, 0) for k in want} == want
    # The profiler turned tracing on: the same spans are in memory.
    recorded = {}
    for s in tracing.spans():
        recorded[s.name] = recorded.get(s.name, 0) + 1
    assert recorded == want


# ------------------------------------------------------------------ W1


def test_batched_w1_counts_its_cg_trips_and_newton_iterations(monkeypatch):
    """B = 4 on 16 x 24: ``beckmann.cg_trips`` is the sum over the solve's
    CG loops of their body executions, each ``beckmann.newton`` span one
    Newton iteration, each holding one pressure solve."""
    trips = []
    original = tbk.iterate_while_batched

    def counted(*args, **kwargs):
        state, counts = original(*args, **kwargs)
        trips.append(int(counts.max()))
        return state, counts

    monkeypatch.setattr(tbk, "iterate_while_batched", counted)
    src, dst = _w1_batch(B=4)
    solve = batched_wasserstein(W1_GRID, 1.0 / W1_GRID[1], None, W1_OPTIONS)
    before = tracing.counter("beckmann.cg_trips")
    with tracing.recording():
        distances, iterations, statuses = solve(src, dst)
    assert len(trips) >= 2 and sum(trips) > 0
    assert tracing.counter("beckmann.cg_trips") - before == sum(trips)
    spans = tracing.spans()
    [root] = [s for s in spans if s.name == "beckmann.solve"]
    assert root.attrs == {"pairs": 4} and root.parent is None
    tree = _under(spans, root)
    assert len(tree) == len(spans)
    assert sum(s.counts.get("beckmann.cg_trips", 0) for s in tree) == sum(trips)
    newton = [s for s in tree if s.name == "beckmann.newton"]
    assert len(newton) == int(iterations.max())
    assert [s.attrs["iteration"] for s in newton] == list(range(len(newton)))
    pressure = [s for s in tree if s.name == "beckmann.pressure"]
    assert len(pressure) == len(newton) + 1  # the Darcy start, then one per iteration
    assert pressure[0].parent == root.id
    for s in newton:
        assert len(_children(spans, s, "beckmann.pressure")) == 1 and _within(s, root)
    assert all(set(s.counts) <= {"beckmann.cg_trips"} for s in tree)
    assert all(s.counts.get("beckmann.cg_trips", 0) > 0 for s in pressure)


def test_single_problem_solve_has_its_span():
    src, dst = (t[0].numpy() for t in _w1_batch(B=1))
    grid = dt.Grid(W1_GRID, 1.0 / W1_GRID[1])
    solver = dt.BeckmannNewtonSolver(grid, None, dict(W1_OPTIONS, return_info=True))
    height = W1_GRID[0] / W1_GRID[1]
    images = [dt.ScalarImage(torch.from_numpy(a), width=1.0, height=height) for a in (src, dst)]
    with tracing.recording():
        _, info = solver(*images)
    spans = tracing.spans()
    [root] = [s for s in spans if s.name == "beckmann.solve"]
    assert root.attrs == {"pairs": 1}
    newton = [s for s in spans if s.name == "beckmann.newton"]
    assert len(newton) == len(info["convergence_history"]["distance"])
    assert all(s.parent == root.id or s.parent in {n.id for n in newton} for s in spans if s is not root)


# ------------------------------------------------------------------ counters


def test_counts_go_to_the_innermost_open_span():
    with tracing.recording():
        with tracing.span("outer") as outer:
            tracing.count("tests.n", 2)
            with tracing.span("inner") as inner:
                tracing.count("tests.n", 3)
                tracing.count("tests.m")
            tracing.count("tests.n")
    assert outer.counts == {"tests.n": 3}
    assert inner.counts == {"tests.n": 3, "tests.m": 1}
    assert inner.parent == outer.id and outer.parent is None


def test_counter_lock_holds_under_the_prefetch_threads():
    """16 prefetch workers count and open spans, switching as often as the
    interpreter allows: no increment is lost, and each worker's spans have
    its own parents."""
    per_item, items = 400, list(range(64))
    before = tracing.counter("tests.prefetch")

    def work(item):
        with tracing.span("tests.item", item=item) as outer:
            for _ in range(per_item):
                tracing.count("tests.prefetch")
            with tracing.span("tests.inner") as inner:
                tracing.count("tests.prefetch")
        return outer, inner

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            results = list(prefetch_map(work, items, depth=17, workers=16))
    finally:
        sys.setswitchinterval(interval)
    assert all(r.ok for r in results)
    assert tracing.counter("tests.prefetch") - before == len(items) * (per_item + 1)
    threads = set()
    for r in results:
        outer, inner = r.value
        assert outer.counts == {"tests.prefetch": per_item}
        assert inner.counts == {"tests.prefetch": 1}
        assert inner.parent == outer.id and outer.parent is None
        assert inner.thread == outer.thread
        threads.add(outer.thread)
    assert threading.get_ident() not in threads
    assert len(tracing.spans()) == 2 * len(items)


def test_the_ring_keeps_the_last_spans():
    extra = 10
    with tracing.recording():
        for k in range(tracing.CAPACITY + extra):
            with tracing.span("tests.ring", k=k):
                pass
    spans = tracing.spans()
    assert len(spans) == tracing.CAPACITY
    assert spans[0].attrs["k"] == extra and spans[-1].attrs["k"] == tracing.CAPACITY + extra - 1
    tracing.reset()
    assert tracing.spans() == []


def test_a_span_closes_on_an_exception():
    with tracing.recording():
        with pytest.raises(ValueError):
            with tracing.span("tests.raises"):
                raise ValueError("inside")
        with tracing.span("tests.after") as after:
            pass
    first = tracing.spans()[0]
    assert first.end_ns is not None and after.parent is None


# ------------------------------------------------------------------ CUDA events


class _FakeEvent:
    """A timing event on a fake stream: ``record`` stamps the fake device
    clock; ``done`` says whether the stream has passed it."""

    made = 0
    clock = 0.0
    done = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.stamp = None

    def record(self, stream):
        assert stream == "stream"
        type(self).clock += 1.5
        self.stamp = type(self).clock
        self.passed = type(self).done

    def query(self):
        return self.passed

    def synchronize(self):
        self.passed = True

    def elapsed_time(self, end):
        assert self.passed and end.passed
        return end.stamp - self.stamp


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "done", True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(tracing, "_current_stream", lambda index: "stream")
    monkeypatch.setattr(tracing, "_free_events", {})
    monkeypatch.setattr(tracing, "_pending", tracing.deque())
    return _FakeEvent


def test_device_time_is_the_stream_time_between_the_two_events(fake_cuda):
    with tracing.recording():
        with tracing.span("outer", "cuda:0") as outer:
            with tracing.span("inner", torch.device("cuda:0")) as inner:
                pass
            assert outer.device_ms is None  # open
    # Stamps: outer 1.5, inner 3.0 .. 4.5, outer's end 6.0.
    assert inner.device_ms == pytest.approx(1.5)
    assert outer.device_ms == pytest.approx(4.5)
    with tracing.recording():
        with tracing.span("host only") as host:
            pass
    assert host.device_ms is None


def test_events_return_to_the_pool_once_they_have_completed(fake_cuda):
    """Completed pairs are read and reused by later spans: a long run of
    spans makes a handful of events, each span keeps its own time."""
    with tracing.recording():
        got = []
        for _ in range(200):
            with tracing.span("tests.pooled", "cuda:0") as s:
                pass
            got.append(s)
    assert fake_cuda.made <= 6
    assert all(s.device_ms == pytest.approx(1.5) for s in got)


def test_events_still_ahead_on_the_stream_are_not_reused(fake_cuda):
    """Spans whose end events the stream has not passed keep their own
    events (no wait); once it has, reading waits for nothing and frees them."""
    fake_cuda.done = False
    with tracing.recording():
        ahead = []
        for _ in range(20):
            with tracing.span("tests.ahead", "cuda:0") as s:
                pass
            ahead.append(s)
    assert fake_cuda.made == 40
    live = [id(e) for s in ahead for e in s._events[:2]]
    assert len(set(live)) == 40
    for s in ahead:
        for e in s._events[:2]:
            e.passed = True
    fake_cuda.done = True
    with tracing.recording():
        for _ in range(30):
            with tracing.span("tests.after", "cuda:0"):
                pass
    assert fake_cuda.made == 40  # the freed pairs were reused
    assert all(s.device_ms == pytest.approx(1.5) for s in ahead)
