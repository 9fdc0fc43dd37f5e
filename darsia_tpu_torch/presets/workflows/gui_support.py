"""Headless building blocks of the workflow GUI: step parameter forms, the
batch monitor, the preview store, dialog text, the config set, the session
cache, templates and the config editor.

Counterpart of :mod:`darsia_tpu.presets.workflows.gui_support`: display-free
state objects that the Tk layer renders.  :meth:`PreviewStore.as_display`
copies an image on the card to the host once and strides the copy.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Optional

__all__ = [
    "StepParameter",
    "step_parameters",
    "validate_options",
    "BatchMonitor",
    "PreviewStore",
    "format_duration",
    "workflow_start_message",
    "workflow_done_message",
    "workflow_error_message",
    "completion_dialog",
    "normalize_config_paths",
    "deduplicate_paths",
    "move_item",
    "ConfigManager",
    "resolve_rig_class",
    "default_session_cache_file",
    "read_session_cache",
    "write_session_cache",
    "template_config_path",
    "new_config_from_template",
    "results_folder_for_step",
    "open_in_file_explorer",
    "ConfigEditorModel",
    "dashboard_lines",
    "encode_error_details",
    "decode_error_details",
    "conflict_choice_to_policy",
    "utils_bundle_defaults",
]


# --------------------------------------------------------------- parameters


@dataclass(frozen=True)
class StepParameter:
    """One form field of a workflow step."""

    name: str
    label: str
    type: str = "bool"  # bool | int | float | str | choice
    default: Any = None
    choices: tuple = ()
    help: str = ""


_COMMON = (
    StepParameter(
        "all_images",
        "Process all images",
        "bool",
        False,
        help="Run over the whole imaging protocol instead of the latest image.",
    ),
)

#: Extra per-step fields beyond the common ones.  Steps not listed take
#: only the common fields.
_STEP_SPECIFIC: dict[str, tuple[StepParameter, ...]] = {
    "analysis: fingers": (
        StepParameter(
            "write_plots",
            "Write overlay PNGs",
            "bool",
            True,
            help="Per-image tips/fjords/skeleton/path overlays.",
        ),
    ),
    "comparison: wasserstein": (
        StepParameter(
            "mode",
            "Mode",
            "choice",
            "compute",
            choices=("compute", "assemble"),
            help="Compute pairwise W1 distances or assemble the CSV.",
        ),
        StepParameter(
            "skip_existing",
            "Skip existing results",
            "bool",
            False,
            help="Leave already-computed wasserstein_*.json untouched.",
        ),
    ),
}


def step_parameters(step: str) -> tuple[StepParameter, ...]:
    """Form fields for one step (common + step-specific)."""
    return _COMMON + _STEP_SPECIFIC.get(step, ())


_COERCE = {
    "bool": lambda v: bool(v) if not isinstance(v, str)
    else v.strip().lower() in ("1", "true", "yes", "on"),
    "int": int,
    "float": float,
    "str": str,
    "choice": str,
}


def validate_options(step: str, options: Optional[dict]) -> dict:
    """Coerce + validate form values; unknown keys are an error.

    Returns a complete option dict (defaults filled in).
    """
    specs = {p.name: p for p in step_parameters(step)}
    options = dict(options or {})
    unknown = set(options) - set(specs)
    if unknown:
        raise KeyError(
            f"Unknown option(s) {sorted(unknown)} for step {step!r}; "
            f"known: {sorted(specs)}"
        )
    out = {}
    for name, spec in specs.items():
        if name in options:
            value = _COERCE[spec.type](options[name])
            if spec.type == "choice" and value not in spec.choices:
                raise ValueError(
                    f"{step!r} option {name!r}: {value!r} not in {spec.choices}"
                )
        else:
            value = spec.default
        out[name] = value
    return out


# ------------------------------------------------------------ batch monitor


def format_duration(seconds: Optional[float]) -> str:
    """HH:MM:SS (or --:--:-- when unknown)."""
    if seconds is None or not (seconds >= 0):
        return "--:--:--"
    s = int(round(seconds))
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


class BatchMonitor:
    """Progress/ETA state over a stream of typed progress events.

    Feed it the worker's progress events (``step_start`` /
    ``image_progress`` / ``step_complete``); read ``text()`` for the
    dashboard line.  The ETA uses a rolling average of the last
    ``window`` per-image durations (robust against the compile-dominated
    first image).
    """

    def __init__(self, window: int = 5) -> None:
        self.window = window
        self.reset()

    def reset(self, step: str = "", total: int = 0) -> None:
        self.step = step
        self.total = int(total)
        self.processed = 0
        self.durations: list[float] = []
        self.status = "idle"

    def update(self, event: dict) -> None:
        kind = event.get("event")
        if kind == "step_start":
            self.reset(
                step=event.get("step", self.step),
                total=event.get("image_total", 0),
            )
            self.status = "running"
        elif kind == "image_progress":
            self.processed = int(event.get("image_index", self.processed + 1))
            self.total = int(event.get("image_total", self.total))
            duration = event.get("image_duration_s")
            if duration is not None:
                self.durations.append(float(duration))
            self.status = "running"
        elif kind == "step_complete":
            self.status = "done"

    def average_runtime(self) -> Optional[float]:
        if not self.durations:
            return None
        tail = self.durations[-self.window:]
        return sum(tail) / len(tail)

    def remaining(self) -> int:
        return max(self.total - self.processed, 0)

    def percent(self) -> float:
        if self.total <= 0:
            return 0.0
        return min(100.0 * self.processed / self.total, 100.0)

    def eta_seconds(self) -> Optional[float]:
        avg = self.average_runtime()
        if avg is None:
            return None
        return avg * self.remaining()

    def text(self) -> str:
        if self.status == "idle":
            return "idle"
        if self.status == "done":
            return f"{self.step}: done ({self.processed}/{self.total})"
        avg = self.average_runtime()
        avg_txt = f"{avg:.1f} s/img" if avg is not None else "-- s/img"
        return (
            f"{self.step}: {self.processed}/{self.total} "
            f"({self.percent():.0f}%) — {avg_txt} — "
            f"ETA {format_duration(self.eta_seconds())}"
        )


# ------------------------------------------------------------ preview store


class PreviewStore:
    """Latest streamed preview frame per key, with a selection cursor."""

    def __init__(self) -> None:
        self._images: dict[str, Any] = {}
        self._selected: Optional[str] = None

    def update(self, images: Optional[dict]) -> None:
        if not images:
            return
        self._images.update(images)
        if self._selected is None and self._images:
            self._selected = next(iter(self._images))

    def keys(self) -> list[str]:
        return list(self._images)

    def select(self, key: str) -> None:
        if key not in self._images:
            raise KeyError(f"No preview {key!r}; have {self.keys()}")
        self._selected = key

    @property
    def selected(self) -> Optional[str]:
        return self._selected

    def selected_image(self):
        if self._selected is None:
            return None
        return self._images[self._selected]

    def as_display(self, max_size: int = 480):
        """Selected image as a uint8 RGB array bounded to ``max_size``
        (the Tk canvas renders exactly this)."""
        import numpy as np

        from ...image.image import as_numpy

        img = self.selected_image()
        if img is None:
            return None
        arr = as_numpy(img.img if hasattr(img, "img") else img)
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, axis=-1)
        if np.issubdtype(arr.dtype, np.floating):
            lo, hi = float(arr.min()), float(arr.max())
            arr = (arr - lo) / (hi - lo) if hi > lo else arr * 0.0
            arr = (255 * arr).astype(np.uint8)
        stride = max(int(np.ceil(max(arr.shape[:2]) / max_size)), 1)
        return np.ascontiguousarray(arr[::stride, ::stride, :3])


# ------------------------------------------------------------- dialog text


def workflow_start_message(step: str, config: str) -> str:
    return f"Running '{step}' with {config} ..."


def workflow_done_message(step: str, elapsed_s: Optional[float]) -> str:
    return f"'{step}' finished in {format_duration(elapsed_s)}."


def workflow_error_message(step: str, error: str) -> str:
    first = error.strip().splitlines()[0] if error.strip() else "unknown error"
    return f"'{step}' failed: {first}"


def completion_dialog(
    step: str,
    failed: bool,
    elapsed_s: Optional[float] = None,
    error: str = "",
    results_folder: Optional[str] = None,
) -> dict:
    """Declarative done/error dialog (title/message/buttons) the Tk layer
    renders verbatim — mirrors the reference's completion_dialog_spec."""
    if failed:
        return {
            "title": "Workflow failed",
            "message": workflow_error_message(step, error),
            "details": error,
            "buttons": ["OK", "Show details"],
        }
    buttons = ["OK"]
    if results_folder:
        buttons.append("Open results folder")
    return {
        "title": "Workflow finished",
        "message": workflow_done_message(step, elapsed_s),
        "results_folder": results_folder,
        "buttons": buttons,
    }


# ------------------------------------------------------- config-set manager
#
# The reference GUI manages an *ordered list* of TOML config files whose
# sections deep-merge left-to-right (``user_interface_gui.py:98-173,
# 959-1005``: add/remove/reorder, session cache with rig spec, new-from-
# template).  Here the same capability is a display-free model the Tk list
# box renders.


def normalize_config_paths(raw: Iterable[Any]) -> list[Path]:
    """Strip/expand/absolutize path strings, dropping blanks + duplicates
    while preserving order (first occurrence wins)."""
    out: list[Path] = []
    seen: set[Path] = set()
    for item in raw:
        text = str(item).strip()
        if not text:
            continue
        path = Path(text).expanduser().resolve()
        if path not in seen:
            seen.add(path)
            out.append(path)
    return out


def deduplicate_paths(paths: Iterable[Path]) -> list[Path]:
    """Order-preserving de-duplication of Path objects."""
    out: list[Path] = []
    seen: set[Path] = set()
    for path in paths:
        if path not in seen:
            seen.add(path)
            out.append(path)
    return out


def move_item(items: list, index: int, delta: int) -> int:
    """Move ``items[index]`` by ``delta`` positions in place; returns the
    new index (clamped to the list bounds)."""
    if not items:
        raise IndexError("Cannot move within an empty list.")
    if not 0 <= index < len(items):
        raise IndexError(f"Index {index} out of range for {len(items)} items.")
    new_index = min(max(index + delta, 0), len(items) - 1)
    item = items.pop(index)
    items.insert(new_index, item)
    return new_index


class ConfigManager:
    """Ordered multi-file TOML config set (later files override earlier).

    The merge semantics are exactly :func:`..config.toml_utils.read_toml`'s
    — the same function every CLI front-end uses — so what the GUI previews
    is what the worker runs.
    """

    def __init__(self, paths: Optional[Iterable[Any]] = None) -> None:
        self.paths: list[Path] = normalize_config_paths(paths or [])

    def add(self, path) -> bool:
        """Append a config file; returns False if it was already present."""
        resolved = Path(str(path)).expanduser().resolve()
        if resolved in self.paths:
            return False
        self.paths.append(resolved)
        return True

    def remove(self, index: int) -> Path:
        return self.paths.pop(index)

    def move(self, index: int, delta: int) -> int:
        return move_item(self.paths, index, delta)

    def clear(self) -> None:
        self.paths.clear()

    def as_strings(self) -> list[str]:
        return [str(p) for p in self.paths]

    def merged(self) -> dict:
        """Deep-merged dict of all config files (missing files error)."""
        from .config.toml_utils import read_toml

        if not self.paths:
            return {}
        return read_toml(list(self.paths))

    def results_folder(self) -> Optional[Path]:
        """The configured ``[data].results`` folder, if any."""
        data = self.merged().get("data")
        if not isinstance(data, dict):
            return None
        results = data.get("results")
        if not isinstance(results, str) or not results.strip():
            return None
        return Path(results).expanduser()


def resolve_rig_class(spec: str):
    """Resolve a rig class from ``module.path:ClassName`` notation.

    Empty spec returns the stock :class:`..rig.Rig`.  (Reference
    ``user_interface_gui.py:81-96``.)
    """
    import importlib

    from .rig import Rig

    if not spec or not spec.strip():
        return Rig
    if ":" not in spec:
        raise ValueError(
            "Rig class must be formatted as 'module.path:ClassName'."
        )
    module_name, class_name = spec.split(":", maxsplit=1)
    module = importlib.import_module(module_name)
    cls = getattr(module, class_name, None)
    if cls is None:
        raise ValueError(
            f"Class {class_name!r} not found in module {module_name!r}."
        )
    if not isinstance(cls, type) or not issubclass(cls, Rig):
        raise ValueError(f"{spec!r} is not a subclass of Rig.")
    return cls


# ------------------------------------------------------------ session cache

SESSION_CACHE_VERSION = 2


def default_session_cache_file() -> Path:
    """XDG-style default location for the GUI session cache."""
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg).expanduser() if xdg else Path.home() / ".cache"
    return base / "darsia_tpu_torch" / "gui_session.json"


def read_session_cache(path: Path) -> dict:
    """Load the session cache; tolerant of v1 files and corruption.

    Returns a complete state dict: ``config_paths`` (list[str]),
    ``rig_spec`` (str), ``last_step``, ``all_images``, ``history``.
    A v1 cache (single ``config`` key) is migrated transparently.
    """
    state = {
        "config_paths": [],
        "rig_spec": "",
        "last_step": None,
        "all_images": False,
        "history": [],
    }
    path = Path(path)
    if not path.exists():
        return state
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return state
    if not isinstance(data, dict):
        return state
    # v1 migration: single "config" string.
    if "config" in data and "config_paths" not in data:
        config = data.get("config")
        if isinstance(config, str) and config.strip():
            state["config_paths"] = [
                str(p) for p in normalize_config_paths([config])
            ]
    raw_paths = data.get("config_paths", [])
    if isinstance(raw_paths, list):
        normalized = normalize_config_paths(
            [p for p in raw_paths if isinstance(p, str)]
        )
        if normalized:
            state["config_paths"] = [str(p) for p in normalized]
    if isinstance(data.get("rig_spec"), str):
        state["rig_spec"] = data["rig_spec"]
    if isinstance(data.get("last_step"), str):
        state["last_step"] = data["last_step"]
    state["all_images"] = bool(data.get("all_images", False))
    if isinstance(data.get("history"), list):
        state["history"] = data["history"][-50:]
    return state


def write_session_cache(path: Path, state: dict) -> None:
    """Persist the session state (versioned JSON)."""
    payload = {
        "version": SESSION_CACHE_VERSION,
        "config_paths": [str(p) for p in state.get("config_paths", [])],
        "rig_spec": state.get("rig_spec", ""),
        "last_step": state.get("last_step"),
        "all_images": bool(state.get("all_images", False)),
        "history": list(state.get("history", []))[-50:],
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))


# --------------------------------------------------------------- templates


def template_config_path() -> Path:
    """The packaged TOML config template."""
    return Path(__file__).resolve().parent / "templates" / "config.toml"


def new_config_from_template(dest) -> Path:
    """Copy the config template to ``dest`` (refusing to overwrite)."""
    dest = Path(dest).expanduser()
    if dest.exists():
        raise FileExistsError(f"{dest} already exists.")
    template = template_config_path()
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(template.read_text())
    return dest


# --------------------------------------------------- results-folder routing
#
# Map a finished step to the folder its artifacts land in, so the done
# dialog can offer "Open results folder" (reference
# ``user_interface_gui.py:262-393``).  Folder keys follow the repo's own
# config semantics: ``analysis.<mode>.folder`` defaulting to
# ``<results>/<mode>`` (config/analysis.py), media under
# ``<results>/videos``, calibration bundles under ``<results>/calibration``.

_STEP_RESULTS_SUBFOLDER = {
    "analysis: cropping": "cropping",
    "analysis: segmentation": "segmentation",
    "analysis: thresholding": "thresholding",
    "analysis: fingers": "fingers",
    "analysis: mass": "mass",
    "analysis: volume": "volume",
}


# Step label -> (workflow, actions) for gui_helpers' suggestion logic —
# ONE source of truth for per-section folder overrides.
_STEP_WORKFLOW_ACTIONS = {
    "comparison: wasserstein": ("comparison", ["wasserstein compute"]),
    "utils: media": ("utils", ["media"]),
    "utils: export calibration bundle": ("utils", ["export calibration"]),
}


def results_folder_for_step(step: str, config_paths) -> Optional[Path]:
    """Best-effort output folder of a step under the merged config.

    Delegates to :func:`gui_helpers.suggested_workflow_results_folder`
    (the reference's override rules — e.g. ``[wasserstein].results``,
    ``[analysis.<mode>].folder``) so the GUI's "open results" button and
    the suggestion helper can never disagree.
    """
    from .gui_helpers import (
        suggested_analysis_results_folder,
        suggested_workflow_results_folder,
    )

    manager = (
        config_paths
        if isinstance(config_paths, ConfigManager)
        else ConfigManager(config_paths)
    )
    paths = list(getattr(manager, "paths", []) or [])
    if not paths:
        return None
    try:
        if step in _STEP_RESULTS_SUBFOLDER:
            return suggested_analysis_results_folder(
                paths, [_STEP_RESULTS_SUBFOLDER[step]]
            )
        if step in _STEP_WORKFLOW_ACTIONS:
            workflow, actions = _STEP_WORKFLOW_ACTIONS[step]
            return suggested_workflow_results_folder(workflow, paths, actions)
        results = manager.results_folder()
        if results is None:
            return None
        if step.startswith("setup:"):
            return results / "setup"
        if step.startswith("calibration:"):
            return results / "calibration"
        if step.startswith("utils:"):
            return results / "calibration"
        return results
    except Exception:
        return None


def open_in_file_explorer(path, runner=None) -> list[str]:
    """Open ``path`` in the OS file browser; returns the command used.

    Walks up to the nearest existing ancestor (a failed run may not have
    created the folder).  ``runner`` (default ``subprocess.Popen``) is
    injectable for tests.
    """
    target = Path(path).expanduser().resolve()
    while not target.exists() and target.parent != target:
        target = target.parent
    if sys.platform.startswith("darwin"):
        command = ["open", str(target)]
    elif os.name == "nt":
        command = ["explorer", str(target)]
    else:
        command = ["xdg-open", str(target)]
    (runner or subprocess.Popen)(command)
    return command


# ------------------------------------------------------------ config editor


class ConfigEditorModel:
    """Text-editor state for one TOML config file (dirty tracking,
    save/save-as, TOML syntax validation) — the Tk text widget renders
    ``text`` and calls the mutators."""

    def __init__(self) -> None:
        self.path: Optional[Path] = None
        self.text: str = ""
        self._saved_text: str = ""

    @property
    def dirty(self) -> bool:
        return self.text != self._saved_text

    def open(self, path) -> str:
        path = Path(path).expanduser()
        self.text = path.read_text()
        self._saved_text = self.text
        self.path = path
        return self.text

    def set_text(self, text: str) -> None:
        self.text = text

    def validate(self) -> Optional[str]:
        """TOML parse check; returns the error message or None."""
        import tomllib

        try:
            tomllib.loads(self.text)
        except tomllib.TOMLDecodeError as exc:
            return str(exc)
        return None

    def save(self) -> Path:
        if self.path is None:
            raise ValueError("No file open; use save_as().")
        return self.save_as(self.path)

    def save_as(self, path) -> Path:
        error = self.validate()
        if error is not None:
            raise ValueError(f"Config is not valid TOML: {error}")
        path = Path(path).expanduser()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.text)
        self.path = path
        self._saved_text = self.text
        return path


# --------------------------------------------------------------- dashboard


def dashboard_lines(config_paths, rig_spec: str = "") -> list[str]:
    """Human-readable summary of the loaded config set (the reference
    dashboard pane, ``user_interface_gui.py:1247-1260,2344-2374``)."""
    manager = (
        config_paths
        if isinstance(config_paths, ConfigManager)
        else ConfigManager(config_paths)
    )
    lines = [f"Config files: {len(manager.paths)}"]
    for i, path in enumerate(manager.paths):
        marker = "missing! " if not path.exists() else ""
        lines.append(f"  {i + 1}. {marker}{path}")
    if not manager.paths:
        lines.append("  (none selected)")
        return lines
    try:
        merged = manager.merged()
    except Exception as exc:
        lines.append(f"Merge error: {exc}")
        return lines
    data = merged.get("data", {}) if isinstance(merged.get("data"), dict) else {}
    for key in ("images", "baseline", "results"):
        value = data.get(key)
        if value:
            lines.append(f"{key.capitalize()}: {value}")
    sections = sorted(k for k, v in merged.items() if isinstance(v, dict))
    lines.append(f"Sections: {', '.join(sections) if sections else '(none)'}")
    lines.append(f"Rig class: {rig_spec or 'darsia_tpu_torch default Rig'}")
    return lines


# ----------------------------------------------------------- error details

_ERROR_DETAILS_MARKER = "__details__:"


def encode_error_details(message: str, details: str) -> str:
    """Pack a one-line error message + full traceback into one queue
    payload (reference encode_workflow_error_details)."""
    return f"{message}\n{_ERROR_DETAILS_MARKER}{details}"


def decode_error_details(payload: str) -> tuple[str, Optional[str]]:
    """Inverse of :func:`encode_error_details`; details None if absent."""
    if _ERROR_DETAILS_MARKER not in payload:
        return payload, None
    message, details = payload.split(_ERROR_DETAILS_MARKER, 1)
    return message.rstrip("\n"), details


def conflict_choice_to_policy(choice: Optional[bool]) -> Optional[str]:
    """Map a yes/no/cancel dialog result to an overwrite policy."""
    if choice is None:
        return None
    return "overwrite" if choice else "skip"


def utils_bundle_defaults(config_paths) -> tuple[str, str]:
    """Default export/import calibration-bundle paths from the config."""
    manager = (
        config_paths
        if isinstance(config_paths, ConfigManager)
        else ConfigManager(config_paths)
    )
    results = None
    try:
        results = manager.results_folder()
    except Exception:
        pass
    if results is None:
        return "", ""
    bundle = results / "calibration" / "calibration_bundle.zip"
    return str(bundle), str(bundle)
