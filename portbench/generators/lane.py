"""Closed-loop generator of an analysis lane: one client, frames from a pool of
pinned host buffers, each call uploading its input without blocking.

Traffic keys (``workloads/<cell>.json``):

* ``loop``: ``"series"`` (each call is one (H, W, T, C) series; with
  ``in_flight`` = 2 the host waits for call k-1 after it has enqueued call
  k, so at most two calls are in flight) or ``"live"`` (each call is one
  frame whose map is copied into a pinned host buffer and synchronised
  before the next frame);
* ``pool_series``, ``series_length``: the pool is made of this many seeded
  series of this many frames (a live pool takes their frames one by one);
* ``check_calls``: how many calls' answers a seeded reservoir keeps for the
  comparison with the reference;
* ``trace_calls``, ``gap_calls``: with ``--trace 1``, after the window, how
  many calls a device-only trace profiles, and how many more a trace of the
  host's operations profiles to name the idle gaps.

The record's times are host-clock seconds, the live frames' latencies CUDA
event milliseconds (from just before the upload to the end of the copy of
the map to the host).
"""

from __future__ import annotations

import math

import torch

from portbench.common import Reservoir, free_device_memory, now, traced


def _host(shape, dtype, device) -> torch.Tensor:
    """A host buffer, page-locked when the lane runs on a card."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Start and end marks of one live frame: CUDA events on a card, the
    host clock elsewhere (the CPU tests)."""

    def __init__(self, device) -> None:
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def mark(self, k: int) -> None:
        if self.cuda:
            self.ev[k].record()
        else:
            setattr(self, f"t{k}", now())

    def wait_ms(self) -> float:
        if self.cuda:
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return 1e3 * (self.t1 - self.t0)


def make_pool(cell, seed, device):
    tr = cell.traffic
    base, series = cell.program.make_inputs(
        cell.config, seed, device, tr["pool_series"], tr["series_length"]
    )
    if tr["loop"] == "series":
        items = series
    else:
        items = [s[:, :, k] for s in series for k in range(tr["series_length"])]
    pool = [_host(x.shape, x.dtype, device).copy_(x) for x in items]
    _sync(device)
    return base, pool


def run(cell, seed, seconds, trace, device, t0):
    tr = cell.traffic
    parts = {"start": now() - t0}
    base, pool = make_pool(cell, seed, device)
    parts["inputs"] = now() - t0
    pipeline = cell.program.build(cell.config, base)
    parts["program"] = now() - t0
    live = tr["loop"] == "live"
    bufs = []
    if live:
        # Pinned host buffers for the maps: one in use and one per kept
        # answer in the window, one for the traced calls after it.
        shape = tuple(pipeline(pool[0].to(device)).img.shape)
        bufs = [_host(shape, torch.float32, device) for _ in range(tr["check_calls"] + 2)]
    window_bufs, trace_buf = bufs[:-1], bufs[-1:]
    # Warm-up: every pool entry once through the window's own loop, with as
    # many answers held as the reservoir will hold.
    warm = max(len(pool), tr["check_calls"] + 2)
    _loop(pipeline, pool, device, 0.0, Reservoir(tr["check_calls"], seed), tr, window_bufs, warm)
    _sync(device)
    setup_s = now() - t0
    parts["warm-up"] = setup_s
    samples = Reservoir(tr["check_calls"], seed)
    rec = _loop(pipeline, pool, device, float(seconds), samples, tr, window_bufs, 0)
    if trace:
        # After the window: its host times are those of an untraced run.
        def more(n):
            _loop(pipeline, pool, device, 0.0, Reservoir(0, seed), tr, trace_buf, n)

        rec["trace"] = traced(tr["trace_calls"], more, tr.get("gap_calls", 0))
        rec["trace"]["frames"] = tr["trace_calls"] * (1 if live else tr["series_length"])
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec["setup_s"] = setup_s
    rec["setup_parts"] = parts
    rec["loop"] = tr["loop"]
    enqueue = sum(rec["enqueue_ms_per_frame"]) / max(1, len(rec["enqueue_ms_per_frame"]))
    rec["notes"] = [
        f"host ms per frame in the program's call {enqueue:.3f}, "
        f"window ms per frame {1e3 * rec['window_s'] / max(1, rec['frames']):.3f}"
    ]
    del pipeline
    free_device_memory()
    tic = now()
    rec["check"] = compare(cell, base, pool, samples.items, live, device)
    rec["check"]["seconds"] = now() - tic
    return rec


def _loop(pipeline, pool, device, seconds, samples, tr, bufs, min_calls):
    """The window (or, with ``seconds`` 0, the warm-up and the traced calls):
    calls until the clock passes ``seconds``, and at least ``min_calls``."""
    live = tr["loop"] == "live"
    per_call = 1 if live else tr["series_length"]
    free = list(bufs)
    buf = free.pop() if live else None
    clock = _Clock(device)
    lat, enqueue = [], []
    pending = []  # completion events of the calls in flight
    depth = max(1, int(tr.get("in_flight", 1)))
    calls = 0
    t_start = now()
    deadline = t_start + seconds
    while calls < min_calls or now() < deadline:
        i = calls % len(pool)
        if live:
            clock.mark(0)
        x = pool[i].to(device, non_blocking=True)
        tic = now()
        out = pipeline(x)
        enqueue.append(1e3 * (now() - tic) / per_call)
        if live:
            buf.copy_(out.img, non_blocking=True)
            clock.mark(1)
            lat.append(clock.wait_ms())
            dropped = samples.offer((i, buf))
            if dropped is None:
                buf = free.pop()
            elif dropped[1] is not buf:
                buf = dropped[1]
        elif device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            samples.offer((i, out.img))
            pending.append(done)
            if len(pending) >= depth:
                pending.pop(0).synchronize()
        else:
            samples.offer((i, out.img))
        calls += 1
    for done in pending:
        done.synchronize()
    window = now() - t_start
    rec = {
        "window_s": window,
        "calls": calls,
        "frames": calls * per_call,
        "attempted": calls * per_call,
        "enqueue_ms_per_frame": enqueue,
    }
    if live:
        rec["frame_ms"] = lat
    return rec


def compare(cell, base, pool, kept, live, device):
    """Each kept answer against the reference, computed from the same raw
    frames after the program is gone: the widest gap of a map's value."""
    limits = cell.config["limits"]
    lane = cell.reference.Lane(cell.config, base)
    worst, failed, compared = 0.0, 0, 0
    for i, got in kept:
        frames = [pool[i]] if live else [pool[i][:, :, k] for k in range(pool[i].shape[2])]
        for k, frame in enumerate(frames):
            ref = lane(frame.to(device))
            have = got.to(device) if live else got[..., k]
            if tuple(have.shape) != tuple(ref.shape) or not bool(torch.isfinite(have).all()):
                err = math.inf
            else:
                err = float((have - ref).abs().max())
            compared += 1
            failed += int(not err <= limits["conc_max_abs_err"])
            worst = max(worst, err)
    if not kept:
        worst, failed = math.inf, 1
    return {
        "correct": failed == 0,
        "failed": failed,
        "compared": compared,
        "numbers": {"conc_max_abs_err": (worst, limits["conc_max_abs_err"])},
    }


def readings(cell, seed, device) -> dict:
    """The two readings a limit is set from, at the cell's size: the widest
    gap between the program's maps of one seeded series and the reference's,
    and between the reference and the control (the reference with its
    image-valued arrays in bfloat16)."""
    tr = cell.traffic
    base, series = cell.program.make_inputs(cell.config, seed, device, 1, tr["series_length"])
    pipeline = cell.program.build(cell.config, base)
    got = pipeline(series[0]).img
    del pipeline
    free_device_memory()
    ref = cell.reference.Lane(cell.config, base)
    ctl = cell.reference.Lane(cell.config, base, dtype=torch.bfloat16)
    prog, control = 0.0, 0.0
    for k in range(series[0].shape[2]):
        frame = series[0][:, :, k]
        r = ref(frame)
        prog = max(prog, float((got[..., k] - r).abs().max()))
        control = max(control, float((ctl(frame) - r).abs().max()))
    return {"conc_max_abs_err": {"program": prog, "control": control}}
