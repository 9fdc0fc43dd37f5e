"""Pure helpers of the workflow GUI.

Counterpart of :mod:`darsia_tpu.presets.workflows.gui_helpers`: path
normalisation, queue hygiene, error-detail transport, duration and ETA
arithmetic, run messages and results-folder suggestions, shared by
:mod:`gui_support` and the Tk layer.  Nothing here touches a device;
:func:`launch_workflows_gui` imports tkinter when called.
"""

from __future__ import annotations

from pathlib import Path
from queue import Empty, Full
from typing import Any, Optional

__all__ = [
    "normalize_paths",
    "deduplicate_paths",
    "clear_queue",
    "publish_latest_queue_item",
    "encode_workflow_error_details",
    "decode_workflow_error_details",
    "enabled_option_labels",
    "format_duration_seconds",
    "rolling_average_runtime",
    "remaining_image_count",
    "estimate_remaining_time_seconds",
    "progress_percent",
    "format_batch_monitor_text",
    "resolve_utils_bundle_defaults",
    "map_conflict_dialog_choice_to_policy",
    "format_workflow_start_message",
    "format_workflow_done_message",
    "format_workflow_error_message",
    "completion_dialog_spec",
    "format_error_details_text",
    "abort_process",
    "suggested_analysis_results_folder",
    "suggested_workflow_results_folder",
    "launch_workflows_gui",
]

# Log-queue sentinel for structured error details (reference :94).
WORKFLOW_ERROR_DETAILS_PREFIX = "__DARSIA_WORKFLOW_ERROR_DETAILS__:"


# ------------------------------------------------------------------ paths


def normalize_paths(paths: list) -> list:
    """Unique absolute Paths from raw strings, order preserved, blanks
    dropped (reference :98-111)."""
    out: list = []
    for raw in paths:
        text = str(raw).strip()
        if text:
            path = Path(text).expanduser().resolve()
            if path not in out:
                out.append(path)
    return out


def deduplicate_paths(paths: list) -> list:
    """Order-preserving Path dedup (reference :113-124)."""
    out: list = []
    for path in paths:
        if path not in out:
            out.append(path)
    return out


# ------------------------------------------------------------------ queues


def clear_queue(queue) -> None:
    """Drain every queued item (reference :214-220)."""
    try:
        while True:
            queue.get_nowait()
    except Empty:
        pass


def publish_latest_queue_item(queue, payload: Any) -> None:
    """Replace the queue content with the newest payload (reference
    :223-229)."""
    clear_queue(queue)
    try:
        queue.put_nowait(payload)
    except Full:
        pass


# ----------------------------------------------------------- error details


def encode_workflow_error_details(details: str) -> str:
    """Wrap traceback text for log-queue transport (reference :232-234)."""
    return WORKFLOW_ERROR_DETAILS_PREFIX + details


def decode_workflow_error_details(message: str) -> Optional[str]:
    """Unwrap transported error details, None for ordinary log lines
    (reference :237-241)."""
    if message.startswith(WORKFLOW_ERROR_DETAILS_PREFIX):
        return message[len(WORKFLOW_ERROR_DETAILS_PREFIX):]
    return None


def format_error_details_text(details: str) -> str:
    """Normalized traceback text for the detail pane (reference
    :625-630)."""
    details = details.strip()
    return details if details else "No workflow error details available."


# ------------------------------------------------------- durations / ETA


def format_duration_seconds(seconds) -> str:
    """H:MM:SS / M:SS rendering, 'n/a' for unknown (reference :455-468)."""
    if not isinstance(seconds, (int, float)) or isinstance(seconds, bool):
        return "n/a"
    value = float(seconds)
    if value < 0 or value != value:
        return "n/a"
    total = int(round(value))
    hours, minutes, secs = total // 3600, (total % 3600) // 60, total % 60
    return (
        f"{hours}:{minutes:02d}:{secs:02d}" if hours else f"{minutes}:{secs:02d}"
    )


def rolling_average_runtime(runtimes: list, *, max_samples: int = 5):
    """Rolling mean of the last valid per-image runtimes (reference
    :470-484)."""
    if max_samples <= 0:
        return None
    valid = [
        float(r)
        for r in runtimes
        if isinstance(r, (int, float))
        and not isinstance(r, bool)
        and r > 0
        and r == r
    ]
    if not valid:
        return None
    tail = valid[-max_samples:]
    return sum(tail) / len(tail)


def remaining_image_count(processed: int, total: int) -> int:
    """Images left in the batch (reference :487-489)."""
    return max(0, max(0, total) - max(0, processed))


def estimate_remaining_time_seconds(
    avg_runtime_seconds, processed_images: int, total_images: int
):
    """ETA = average runtime x remaining count; None until two images have
    completed (reference :492-507, which keeps the compile-dominated first
    image out of the estimate)."""
    if avg_runtime_seconds is None or avg_runtime_seconds <= 0:
        return None
    if processed_images < 2:
        return None
    remaining = remaining_image_count(processed_images, total_images)
    return 0.0 if remaining <= 0 else avg_runtime_seconds * remaining


def progress_percent(processed: int, total: int) -> float:
    """Clamped batch progress percentage (reference :510-514)."""
    if total <= 0:
        return 0.0
    return min(100.0, max(0.0, 100.0 * max(0, processed) / total))


def format_batch_monitor_text(
    *,
    step: str,
    image_path: str,
    processed: int,
    total: int,
    last_image_seconds=None,
    step_elapsed_seconds=None,
    overall_elapsed_seconds=None,
    eta_seconds=None,
) -> str:
    """Multi-line batch dashboard text (reference :517-540)."""
    return "\n".join(
        [
            f"Current analysis step: {step or 'n/a'}",
            f"Current image path: {image_path or 'n/a'}",
            f"Image count: {processed}/{total} "
            f"({progress_percent(processed, total):.1f}%)",
            f"Last image elapsed: {format_duration_seconds(last_image_seconds)}",
            f"Current step elapsed: "
            f"{format_duration_seconds(step_elapsed_seconds)}",
            f"Overall elapsed: "
            f"{format_duration_seconds(overall_elapsed_seconds)}",
            f"Estimated remaining: {format_duration_seconds(eta_seconds)}",
        ]
    )


# --------------------------------------------------------------- options


def enabled_option_labels(options: dict, *, exclude=None) -> list:
    """Human-readable labels of enabled boolean options (reference
    :443-452)."""
    excluded = exclude or set()
    return [
        key.replace("_", " ")
        for key, enabled in options.items()
        if enabled and key not in excluded
    ]


def resolve_utils_bundle_defaults(config_paths: list) -> tuple:
    """Configured default export/import bundle paths, empty strings when
    unset (reference :543-564)."""
    from .config.workflow_utils import WorkflowUtilsConfig

    paths = normalize_paths(config_paths)
    if not paths:
        return "", ""
    try:
        config = WorkflowUtilsConfig().load(paths if len(paths) > 1 else paths[0])
    except (KeyError, FileNotFoundError):
        return "", ""
    export_bundle = getattr(config, "export_calibration_bundle", None)
    import_bundle = getattr(config, "import_calibration_bundle", None)
    return (
        "" if export_bundle is None else str(export_bundle),
        "" if import_bundle is None else str(import_bundle),
    )


def map_conflict_dialog_choice_to_policy(choice):
    """askyesnocancel result -> import conflict policy (reference
    :567-573)."""
    if choice is True:
        return "overwrite_all"
    if choice is False:
        return "skip_all"
    return None


# -------------------------------------------------------------- messages


def format_workflow_start_message(
    workflow: str, actions: list, config_paths: list, rig_spec: str
) -> str:
    """Run-start log line (reference :576-586)."""
    configs = ", ".join(Path(p).as_posix() for p in config_paths)
    rig = rig_spec.strip() or "darsia_tpu_torch.presets.workflows.rig:Rig"
    return (
        f"Starting {workflow} workflow. "
        f"Actions: {', '.join(actions) or 'none'}. "
        f"Configs: {configs}. Rig: {rig}."
    )


def format_workflow_done_message(
    workflow: str, actions: list, config_count: int, duration_seconds: float
) -> str:
    """Completion log line (reference :589-597)."""
    return (
        f"{workflow.capitalize()} completed. "
        f"Actions: {', '.join(actions) or 'none'}. "
        f"Configs: {config_count}. Duration: {duration_seconds:.1f}s."
    )


def format_workflow_error_message(workflow: str, actions: list, exit_code) -> str:
    """Failure log line (reference :600-607)."""
    return (
        f"ERROR: {workflow} workflow failed with exit code {exit_code}. "
        f"Actions: {', '.join(actions) or 'none'}."
    )


def completion_dialog_spec(workflow: str, exit_code, abort_requested: bool):
    """(kind, title, message) for the terminal dialog; None when the user
    aborted (reference :610-622)."""
    if abort_requested:
        return None
    if exit_code == 0:
        return ("info", "Done", f"{workflow.capitalize()} workflow completed.")
    return (
        "error",
        "Error",
        f"{workflow.capitalize()} workflow failed with exit code {exit_code}.",
    )


# --------------------------------------------------------------- process


def abort_process(process) -> bool:
    """Terminate (then kill) a live worker process; True if one was
    aborted (reference :633-652)."""
    if process is None or not process.is_alive():
        return False
    process.terminate()
    process.join(timeout=1.0)
    if process.is_alive():
        process.kill()
        process.join(timeout=1.0)
    return True


# ------------------------------------------------------ folder suggestions

_ANALYSIS_MODE_SUBFOLDER = {
    "mass": "mass",
    "volume": "volume",
    "segmentation": "segmentation",
    "fingers": "fingers",
    "thresholding": "thresholding",
    "cropping": "cropping",
}


def _merged_results_folder(config_paths: list):
    from .config.toml_utils import read_toml

    try:
        merged = read_toml([Path(p) for p in config_paths])
    except FileNotFoundError:
        return None, {}
    results = merged.get("data", {}).get("results")
    return (Path(results).expanduser() if results else None), merged


def suggested_analysis_results_folder(config_paths: list, actions: list):
    """Folder an analysis run writes into, from the merged config
    (reference :273-299): exactly one mode action narrows the suggestion
    to that mode's (possibly overridden) subfolder."""
    results, merged = _merged_results_folder(config_paths)
    if results is None:
        return None
    modes = [a for a in actions if a in _ANALYSIS_MODE_SUBFOLDER]
    if len(modes) != 1:
        return results
    mode = modes[0]
    section = merged.get("analysis", {}).get(mode, {})
    folder = section.get("folder") if isinstance(section, dict) else None
    if isinstance(folder, str) and folder.strip():
        return Path(folder).expanduser()
    return results / _ANALYSIS_MODE_SUBFOLDER[mode]


def suggested_workflow_results_folder(
    workflow: str, config_paths: list, actions: list
):
    """Folder any workflow run writes into (reference :301-440)."""
    results, merged = _merged_results_folder(config_paths)
    if results is None:
        return None
    if workflow == "analysis":
        return suggested_analysis_results_folder(config_paths, actions)
    selected = {str(a).strip().lower() for a in actions}
    if workflow == "setup":
        for action, sub in (
            ("depth", ("setup", "depth")),
            ("segmentation", ("setup", "labels")),
            ("facies", ("setup", "facies")),
            ("rig", ("setup", "rig")),
            ("protocol", ("setup",)),
            ("all", ("setup",)),
        ):
            if action in selected:
                return results.joinpath(*sub)
        return None
    if workflow == "calibration":
        return results / "calibration"
    if workflow == "comparison":
        # Config overrides win (reference :343-368): [events].path's parent
        # for events runs, [wasserstein].results for wasserstein runs.
        has_events = "events" in selected
        has_wasserstein = any(
            a.startswith("wasserstein") for a in selected
        )
        if has_events and has_wasserstein:
            return results
        if has_events:
            events = merged.get("events", {})
            path = events.get("path") if isinstance(events, dict) else None
            if isinstance(path, str) and path.strip():
                return Path(path).expanduser().parent
            return results / "events"
        if has_wasserstein:
            wasserstein = merged.get("wasserstein", {})
            override = (
                wasserstein.get("results")
                if isinstance(wasserstein, dict)
                else None
            )
            if isinstance(override, str) and override.strip():
                return Path(override).expanduser()
            return results / "wasserstein"
        return None
    if workflow == "utils":
        candidates = []
        if "media" in selected:
            candidates.append(results / "videos")
        if {"export calibration", "import calibration"} & selected:
            candidates.append(results / "calibration")
        if "download" in selected:
            download = merged.get("download", {})
            folder = (
                download.get("folder") if isinstance(download, dict) else None
            )
            candidates.append(
                Path(folder).expanduser()
                if isinstance(folder, str) and folder.strip()
                else results / "raw_data"
            )
        if not candidates:
            return None
        return (
            candidates[0]
            if all(c == candidates[0] for c in candidates)
            else results
        )
    if workflow == "helper":
        return results
    return results


def launch_workflows_gui() -> None:  # pragma: no cover - requires display
    """Launch the Tk workflows GUI (imports tkinter when called)."""
    from .user_interface_gui import launch_gui

    launch_gui()
