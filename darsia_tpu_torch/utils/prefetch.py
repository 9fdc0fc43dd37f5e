"""Host-side prefetching for per-image analysis loops.

Counterpart of :mod:`darsia_tpu.utils.prefetch`.  The workflow steps read
and correct each photograph inline with the analysis (the hot loop of
``presets/workflows/analysis/analysis_mass.py``).  ``prefetch_map`` overlaps
them: a small thread pool runs the read function for upcoming items while the
caller consumes the current one.  On the card every worker launches on the
same (legacy default) stream as the consumer, so PyTorch's caching allocator
keeps its stream order; the launch counters (``utils/tracing.py``), the
kernel build and the curvature grid are guarded by locks
(``ops/warp2pass.py``, ``corrections/shape/curvature.py``).

Failures are reported per item (the result carries the exception), so a
corrupt frame is skipped without tearing down the pool, as the workflow
loops' best-effort semantics ask.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

__all__ = ["prefetch_map", "PrefetchResult", "default_workers"]


class PrefetchResult:
    """Outcome of one prefetched load: ``value`` or ``error``."""

    __slots__ = ("item", "value", "error")

    def __init__(self, item, value=None, error: Optional[BaseException] = None):
        self.item = item
        self.value = value
        self.error = error

    @property
    def ok(self) -> bool:
        return self.error is None


def default_workers() -> int:
    """One worker per host core, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def prefetch_map(
    fn: Callable,
    items: Iterable,
    depth: Optional[int] = None,
    workers: Optional[int] = None,
) -> Iterator[PrefetchResult]:
    """Yield ``PrefetchResult`` for ``fn(item)`` over ``items``, keeping up
    to ``depth`` loads in flight ahead of the consumer.

    Results are yielded in input order.  ``depth <= 0`` (or a single item)
    is the plain sequential loop, without threads.  ``workers`` defaults to
    :func:`default_workers` and ``depth`` to ``workers + 1``, so the pool
    never idles while the consumer holds the oldest result.
    """
    items = list(items)
    if workers is None:
        workers = default_workers()
    if depth is None:
        depth = workers + 1
    if depth <= 0 or len(items) <= 1:
        for item in items:
            try:
                yield PrefetchResult(item, value=fn(item))
            except Exception as exc:  # noqa: BLE001 - best-effort loop
                yield PrefetchResult(item, error=exc)
        return

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        pending = []
        index = 0
        while index < len(items) and len(pending) < depth:
            pending.append((items[index], pool.submit(fn, items[index])))
            index += 1
        while pending:
            item, future = pending.pop(0)
            # Refill before blocking on the oldest future, so the pool keeps
            # working while the consumer waits.
            while index < len(items) and len(pending) < depth:
                pending.append((items[index], pool.submit(fn, items[index])))
                index += 1
            try:
                yield PrefetchResult(item, value=future.result())
            except Exception as exc:  # noqa: BLE001
                yield PrefetchResult(item, error=exc)
