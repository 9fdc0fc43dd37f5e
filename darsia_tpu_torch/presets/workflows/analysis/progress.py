"""Progress events for workflow steps (callback-based).

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.progress` (plain
Python, the same events and payloads).
"""

from __future__ import annotations

import math
from typing import Optional

from typing import Literal, TypedDict

__all__ = [
    "AnalysisProgressEvent",
    "publish_analysis_progress",
    "publish_step_start",
    "publish_image_progress",
    "publish_step_complete",
    "normalize_progress_event",
]


class AnalysisProgressEvent(TypedDict, total=False):
    """Typed payload contract for analysis progress events."""

    event: "Literal['step_start', 'image_progress', 'step_complete']"
    step: str
    image_path: str
    image_index: int
    image_total: int
    image_duration_s: float
    step_elapsed_s: float


def _safe_duration(value) -> Optional[float]:
    if value is None:
        return None
    try:
        duration = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(duration):
        return None
    return max(0.0, duration)


def publish_analysis_progress(progress_callback, payload: dict) -> None:
    if progress_callback is None:
        return
    try:
        progress_callback(payload)
    except Exception:
        pass


def publish_step_start(progress_callback, *, step: str, image_total: int) -> None:
    publish_analysis_progress(
        progress_callback,
        {"event": "step_start", "step": step, "image_total": max(0, image_total)},
    )


def publish_image_progress(
    progress_callback,
    *,
    step: str,
    image_path: str,
    image_index: int,
    image_total: int,
    image_duration_s=None,
    step_elapsed_s=None,
) -> None:
    payload = {
        "event": "image_progress",
        "step": step,
        "image_path": str(image_path),
        "image_index": max(0, int(image_index)),
        "image_total": max(0, int(image_total)),
    }
    duration = _safe_duration(image_duration_s)
    if duration is not None:
        payload["image_duration_s"] = duration
    elapsed = _safe_duration(step_elapsed_s)
    if elapsed is not None:
        payload["step_elapsed_s"] = elapsed
    publish_analysis_progress(progress_callback, payload)


def publish_step_complete(
    progress_callback, *, step: str, image_total: Optional[int] = None,
    step_elapsed_s=None,
) -> None:
    payload = {"event": "step_complete", "step": step}
    if image_total is not None:
        payload["image_total"] = max(0, int(image_total))
    elapsed = _safe_duration(step_elapsed_s)
    if elapsed is not None:
        payload["step_elapsed_s"] = elapsed
    publish_analysis_progress(progress_callback, payload)


def _safe_nonnegative_int(value) -> Optional[int]:
    if value is None or isinstance(value, bool) or not isinstance(value, int):
        return None
    return max(0, value)


def normalize_progress_event(payload) -> Optional[dict]:
    """Validate an arbitrary queue payload into a progress event, or None:
    unknown events and blank step names reject the whole payload;
    non-integer counters and malformed durations are dropped fieldwise,
    negative counters clamp to zero."""
    if not isinstance(payload, dict):
        return None
    event = payload.get("event")
    if event not in {"step_start", "image_progress", "step_complete"}:
        return None
    step = payload.get("step")
    if not isinstance(step, str) or not step.strip():
        return None
    normalized: dict = {"event": event, "step": step.strip()}
    for key in ("image_total", "image_index"):
        value = _safe_nonnegative_int(payload.get(key))
        if value is not None:
            normalized[key] = value
    image_path = payload.get("image_path")
    if isinstance(image_path, str) and image_path:
        normalized["image_path"] = image_path
    for key in ("image_duration_s", "step_elapsed_s"):
        value = _safe_duration(payload.get(key))
        if value is not None:
            normalized[key] = value
    return normalized
