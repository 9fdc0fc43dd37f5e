"""Helpers shared by the traffic generators and the metric readers: the card's name and
power limit, the peak table, seeded sampling of answers, and the reduction of
a profiler trace to busy time, idle gaps and kernel sums."""

from __future__ import annotations

import bisect
import gc
import json
import random
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
#: Device activities counted as busy: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host activities that name an idle gap: the annotations of the generators'
#: own loops and the program's operator calls.
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW_SPAN = "portbench.window"


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``)."""
    table = json.loads((BENCH / "peaks.json").read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in peaks.json")
    return table[kind]


def power_limit() -> str:
    """``name, power.limit`` as nvidia-smi prints them, or why not."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not read: {err}"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else proc.stderr.strip()


class Reservoir:
    """A uniform sample of at most ``size`` items from a stream of unknown
    length, drawn from ``seed`` (Algorithm R).  ``offer`` returns the item it
    evicted, or the offered item itself when it is not taken, or None."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return None
        j = self.rng.randrange(self.seen)
        if j < self.size:
            out, self.items[j] = self.items[j], item
            return out
        return item


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) by ``statistics.quantiles``' default
    (exclusive) method."""
    cuts = statistics.quantiles(values, n=100)
    return cuts[int(round(q * 100)) - 1]


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Tracer:
    """``torch.profiler`` over calls that a generator makes after its window.

    ``start()`` and ``stop()`` bracket the traced calls; ``stop`` closes a
    span named :data:`WINDOW_SPAN` after synchronising the device, so the
    traced window ends when its last operation has, and reduces the trace
    with :func:`summarise_trace`.  With ``cpu`` false only the device's
    activity is recorded, which costs the host least; a second, short trace
    with ``cpu`` true names the idle gaps by what the host was doing.  The
    profiler is never started before the window closes, so the window's
    host times are those of an untraced run.
    """

    def __init__(self, cpu: bool = False) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA]
        if cpu:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.activities = acts
        self.prof = None
        self.span = None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self.activities)
        self.prof.start()
        self.span = torch.autograd.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch

        torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            self.prof = None
            return summarise_trace(path, host_s)


def traced(calls, run, gap_calls: int = 0) -> dict:
    """The summary of a device-only trace of ``run(calls)``, with its idle
    gaps named from a trace of ``run(gap_calls)`` that records the host's
    operations too (when ``gap_calls`` is above 0)."""
    summary = Tracer(cpu=False)
    summary.start()
    run(calls)
    out = summary.stop()
    if gap_calls > 0:
        names = Tracer(cpu=True)
        names.start()
        run(gap_calls)
        out["idle_gaps"] = names.stop()["idle_gaps"]
        out["idle_gaps_from"] = "a host trace of %d call(s) after the device trace" % gap_calls
    return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise_trace(path: Path, host_s: float) -> dict:
    """Busy and idle time, device operations and idle gaps of a trace.

    The window is the :data:`WINDOW_SPAN` span; a trace without host
    activities has none, and its window starts with its first device
    operation and lasts ``host_s``, the host clock's reading of it.  Busy
    time is the union of the device's kernel, copy and fill intervals within
    the window.  Each idle gap is named by the innermost host activity under
    its midpoint, or, without host activities, by the device operation that
    ends it.  Times are seconds.
    """
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    spans = [
        e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
        and e.get("cat") == "user_annotation"
    ]
    if spans:
        w0 = float(spans[0]["ts"])
        w1 = w0 + float(spans[0]["dur"])
    else:
        starts = [float(e["ts"]) for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        if not starts:
            raise ValueError("the trace holds no device operation")
        w0 = min(starts)
        w1 = w0 + 1e6 * host_s
    device, kernels, k_count = [], {}, {}
    host, named = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                device.append((a, b))
                named.append((a, e.get("name", "?")))
            if ts >= w0 and ts <= w1:
                name = e.get("name", "?")
                kernels[name] = kernels.get(name, 0.0) + dur
                if cat == "kernel":
                    k_count[name] = k_count.get(name, 0) + 1
        elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((ts, ts + dur, e.get("name", "?")))
    merged = _merge(device)
    busy = sum(b - a for a, b in merged)
    gaps = []
    edge = w0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    starts = [h[0] for h in host]
    named.sort()
    op_starts = [n[0] for n in named]
    by_host: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "no host activity"
        if not host:
            k = bisect.bisect_left(op_starts, b)
            name = "before " + (named[k][1] if k < len(named) else "the window's end")
        best = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            h0, h1, hname = host[j]
            if h1 >= mid and (best is None or h1 - h0 < best):
                best, name = h1 - h0, hname
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernel_launches": sum(k_count.values()),
        "kernel_counts": k_count,
        "device_ops": sorted(((n, s * 1e-6) for n, s in kernels.items()), key=lambda x: -x[1]),
        "idle_gaps": sorted(((n, s * 1e-6) for n, s in by_host.items()), key=lambda x: -x[1]),
    }


def kernel_time(summary: dict, marker: str) -> tuple:
    """(launches, seconds) of the device operations whose name holds ``marker``."""
    count = sum(c for n, c in summary["kernel_counts"].items() if marker in n)
    secs = sum(s for n, s in summary["device_ops"] if marker in n)
    return count, secs


def now() -> float:
    return time.perf_counter()


def idle_share_pct(rec: dict):
    """1 - busy / window of the traced window, in percent."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mean_enqueue_ms(rec: dict):
    values = rec.get("enqueue_ms_per_frame")
    return statistics.fmean(values) if values else None
