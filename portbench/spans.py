"""Readers' helpers for the program's own spans (``darsia_tpu_torch/utils/
tracing.py``): the spans a ``--trace 1`` run recorded while the profiler
ran after the window, and the stage sums the per-layer metrics take from
them.

A span here is any object with ``name``, ``id``, ``parent``, ``start_ns``,
``end_ns``, ``counts`` and ``device_ms`` (None without CUDA events).  A
program without the tracing module records none: every reader then finds
nothing and returns None.
"""

from __future__ import annotations


def recorded():
    """The program's recorded spans in start order, or None where the
    program has no tracing module."""
    try:
        from darsia_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def _host_ms(span) -> float:
    return 1e-6 * (span.end_ns - span.start_ns)


def below(spans, roots) -> list:
    """The spans under ``roots`` (at any depth, roots excluded)."""
    ids = {r.id for r in roots}
    out = []
    for s in spans:  # start order: a parent opens before its children
        if s.parent in ids:
            out.append(s)
            ids.add(s.id)
    return out


def first(spans, name: str, n) -> list:
    """The first ``n`` closed spans named ``name``, or [] if fewer."""
    got = [s for s in spans if s.name == name and s.end_ns is not None][: int(n or 0)]
    return got if n and len(got) == int(n) else []


def traced_frames(rec: dict):
    """``(spans, frames)``: the recorded spans and the first
    ``rec["trace"]["frames"]`` ``pipeline.frame`` spans, those of the
    device-only trace (the host trace that names the gaps comes after it),
    or None."""
    tr = rec.get("trace") or {}
    spans = recorded()
    if not spans or not tr.get("frames"):
        return None
    frames = first(spans, "pipeline.frame", tr["frames"])
    return (spans, frames) if frames else None


def _per_frame(rec: dict, stage: str, ms):
    """``ms(span)`` summed over the spans named ``stage`` under the traced
    frames, per frame; None where there are none or one reads None."""
    got = traced_frames(rec)
    if got is None:
        return None
    spans, frames = got
    times = [ms(s) for s in below(spans, frames) if s.name == stage and s.end_ns is not None]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(frames)


def stage_host_ms(rec: dict, stage: str):
    """Host ms of the spans named ``stage`` under the traced frames, per
    frame."""
    return _per_frame(rec, stage, _host_ms)


def stage_device_ms(rec: dict, stage: str):
    """Stream ms between the CUDA events of the spans named ``stage``
    under the traced frames, per frame; None without events."""
    return _per_frame(rec, stage, lambda s: s.device_ms)


def assemble_host_ms(rec: dict):
    """Host ms of ``pipeline.assemble`` in the calls that hold the traced
    frames, over those frames."""
    got = traced_frames(rec)
    if got is None:
        return None
    spans, frames = got
    call_ids = {f.parent for f in frames}
    calls = [s for s in spans if s.id in call_ids and s.name == "pipeline.call"]
    parts = [s for s in spans if s.parent in {c.id for c in calls} and s.name == "pipeline.assemble"]
    if not parts or any(s.end_ns is None for s in parts):
        return None
    return sum(_host_ms(s) for s in parts) / len(frames)


def traced_solves(rec: dict):
    """``(spans, solves)``: the recorded spans and the first
    ``rec["trace"]["batches"]`` ``beckmann.solve`` spans, or None."""
    tr = rec.get("trace") or {}
    spans = recorded()
    if not spans or not tr.get("batches"):
        return None
    solves = first(spans, "beckmann.solve", tr["batches"])
    return (spans, solves) if solves else None


def cg_trips(spans, solves) -> int:
    """``beckmann.cg_trips`` counted in the solves and under them."""
    return sum(s.counts.get("beckmann.cg_trips", 0) for s in list(solves) + below(spans, solves))
