"""Tkinter GUI of the workflow steps, and its headless core.

Counterpart of :mod:`darsia_tpu.presets.workflows.user_interface_gui`.  Each
step runs in a worker process started with the ``spawn`` method (a forked
child cannot use CUDA); logs, typed progress events and PNG preview bytes
(the steps encode their previews, ``analysis/streaming.py``) come back
over queues, so every payload is host data, never a tensor.  The
worker computes on ``device`` (the CUDA card when None), which the
:class:`GuiSession` passes on.  A session cache (JSON) keeps the config set
between launches, and a failing step is reported over the log queue with an
error sentinel.  :func:`launch_gui` imports tkinter when called; without
tkinter or a display it raises and names what is missing.

The registry repairs the JAX package's set-up entries (ROADMAP Queue 3,
fault 30): "setup: labeling" and "setup: protocols" name functions (there
they name modules), and a config step receives the rig class and the device
as the keyword arguments it takes (there ``setup_rig(path)`` takes the path
for the class).
"""

from __future__ import annotations

import logging
import logging.handlers
import multiprocessing as mp
import queue
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ...utils.optional import optional_module

logger = logging.getLogger(__name__)

try:
    from typing import Any, Protocol, TypedDict
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore[assignment]
    TypedDict = dict  # type: ignore[assignment]
    Any = object  # type: ignore[assignment]

__all__ = [
    "GuiSession",
    "WorkerHandle",
    "WorkflowGUI",
    "QueueLogHandler",
    "RunContext",
    "SupportsLogQueue",
    "SupportsQueue",
    "UtilsWorkflowOptions",
    "launch_gui",
    "run_step_in_worker",
    "main",
]

# Error sentinel prefix (reference user_interface_gui.py:37).
ERROR_SENTINEL = "__DARSIA_WORKER_ERROR__:"


class SupportsLogQueue(Protocol):
    """Queue-like sink for log forwarding (reference
    ``user_interface_gui.py:42-46``)."""

    def put(self, obj: str) -> "Any":
        """Put one log message in the queue."""


class SupportsQueue(Protocol):
    """Queue-like channel for generic payload forwarding (reference
    ``user_interface_gui.py:49-56``)."""

    def get_nowait(self) -> "Any":
        """Get one queue element without blocking."""

    def put_nowait(self, obj: "Any") -> "Any":
        """Put one queue element without blocking."""


class UtilsWorkflowOptions(TypedDict, total=False):
    """Option payload for the utils workflow launcher (reference
    ``user_interface_gui.py:59-65``)."""

    media: bool
    download: bool
    export_calibration: bool
    import_calibration: bool
    export_bundle: str
    import_bundle: str
    import_conflict_action: str

# Registry of launchable steps: label -> (module, function, kind).
# kind "context" steps receive (ctx, progress_callback, stream_callback);
# kind "config" steps receive the config path, and the rig class and the
# device where they take them; kind "rig_config" steps (cls, path).
STEP_REGISTRY = {
    "setup: rig": (
        "darsia_tpu_torch.presets.workflows.setup", "setup_rig", "config",
    ),
    "setup: depth": (
        "darsia_tpu_torch.presets.workflows.setup", "setup_depth_map", "config",
    ),
    "setup: facies": (
        "darsia_tpu_torch.presets.workflows.setup", "setup_facies", "config",
    ),
    "setup: labeling": (
        "darsia_tpu_torch.presets.workflows.setup", "segment_colored_image", "config",
    ),
    "setup: protocols": (
        "darsia_tpu_torch.presets.workflows.setup", "setup_imaging_protocol", "config",
    ),
    "calibration: color paths": (
        "darsia_tpu_torch.presets.workflows.calibration",
        "calibration_color_paths", "config",
    ),
    "calibration: color to mass": (
        "darsia_tpu_torch.presets.workflows.calibration",
        "calibration_color_to_mass_analysis", "config",
    ),
    "analysis: cropping": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_cropping_from_context", "context",
    ),
    "analysis: segmentation": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_segmentation_from_context", "context",
    ),
    "analysis: thresholding": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_thresholding_from_context", "context",
    ),
    "analysis: fingers": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_fingers_from_context", "context",
    ),
    "analysis: mass": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_mass_from_context", "context",
    ),
    "analysis: volume": (
        "darsia_tpu_torch.presets.workflows.analysis",
        "analysis_volume_from_context", "context",
    ),
    "comparison: wasserstein": (
        "darsia_tpu_torch.presets.workflows.comparison",
        "comparison_wasserstein", "rig_config",
    ),
    "helper: color report": (
        "darsia_tpu_torch.presets.workflows.helper.helper_color",
        "helper_color", "config",
    ),
    "helper: roi overview": (
        "darsia_tpu_torch.presets.workflows.helper.helper_roi",
        "helper_roi_viewer", "config",
    ),
    "utils: media": (
        "darsia_tpu_torch.presets.workflows.utils.utils_media",
        "build_media", "config",
    ),
    "utils: export calibration bundle": (
        "darsia_tpu_torch.presets.workflows.utils.calibration_bundle",
        "export_calibration_bundle", "config",
    ),
}


def _worker(
    module_name: str,
    function_name: str,
    kind: str,
    config_path,
    all_images: bool,
    log_queue,
    progress_queue,
    preview_queue,
    device: Optional[str] = None,
    step_kwargs: Optional[dict] = None,
    rig_spec: str = "",
) -> None:
    """Worker entry point: run one step on ``device``, forward logs,
    progress events and previews; any exception is reported over the log
    queue with the error sentinel instead of killing the GUI."""
    try:
        # `kill -USR1 <worker-pid>` dumps the worker's Python traceback to
        # stderr (for a step that hangs).
        import faulthandler
        import signal as _signal

        faulthandler.register(_signal.SIGUSR1)
    except Exception:
        pass
    root_logger = logging.getLogger()
    root_logger.addHandler(logging.handlers.QueueHandler(log_queue))
    root_logger.setLevel(logging.INFO)

    def progress_callback(event: dict) -> None:
        try:
            progress_queue.put_nowait(event)
        except Exception:
            pass

    def stream_callback(images: dict) -> None:
        try:
            preview_queue.put_nowait(images)
        except Exception:
            pass

    try:
        import importlib
        import inspect

        from .gui_support import resolve_rig_class

        module = importlib.import_module(module_name)
        function = getattr(module, function_name)
        parameters = inspect.signature(function).parameters
        # Multi-file config overlays deep-merge left to right, as the CLI's
        # repeated --config flags do.
        if isinstance(config_path, (list, tuple)):
            paths = [Path(p) for p in config_path]
            path_arg = paths if len(paths) > 1 else paths[0]
        else:
            path_arg = Path(config_path)
        rig_cls = resolve_rig_class(rig_spec)
        if kind == "context":
            from .analysis.analysis_context import prepare_analysis_context

            ctx = prepare_analysis_context(
                cls=rig_cls,
                path=path_arg,
                all=all_images,
                require_color_to_mass=function_name
                in ("analysis_mass_from_context", "analysis_volume_from_context",
                    "analysis_fingers_from_context"),
                device=device,
            )
            kwargs = {}
            if "progress_callback" in parameters:
                kwargs["progress_callback"] = progress_callback
            if "stream_callback" in parameters:
                kwargs["stream_callback"] = stream_callback
            # Validated per-step form options (gui_support.step_parameters)
            # go to the matching keyword parameters.
            for name, value in (step_kwargs or {}).items():
                if name in parameters:
                    kwargs[name] = value
            function(ctx, **kwargs)
        elif kind == "rig_config":
            # Steps taking (rig_cls, path, **options), e.g.
            # comparison_wasserstein(cls, path, compute/assemble).
            kwargs = dict(step_kwargs or {})
            mode = kwargs.pop("mode", None)
            if mode is not None:
                kwargs["compute"] = mode == "compute"
                kwargs["assemble"] = mode == "assemble"
            if "device" in parameters:
                kwargs["device"] = device
            function(rig_cls, path_arg, **kwargs)
        else:
            kwargs = {"cls": rig_cls, "device": device}
            function(path=path_arg, **{k: v for k, v in kwargs.items() if k in parameters})
        progress_queue.put(("__done__", function_name))
    except Exception as exc:  # errors reach the GUI over the queue
        import traceback

        log_queue.put(
            logging.makeLogRecord(
                {
                    "msg": f"{ERROR_SENTINEL}{function_name} failed: {exc}\n"
                    + traceback.format_exc(limit=10),
                    "levelno": logging.ERROR,
                    "levelname": "ERROR",
                }
            )
        )
        progress_queue.put(("__failed__", str(exc)))


@dataclass
class WorkerHandle:
    """A running workflow step with its communication queues."""

    step: str
    process: mp.Process
    log_queue: mp.Queue
    progress_queue: mp.Queue
    preview_queue: mp.Queue
    started_at: float = field(default_factory=time.time)
    finished: bool = False
    failed: bool = False

    def alive(self) -> bool:
        return self.process.is_alive()

    def poll(
        self,
        on_log: Optional[Callable[[str], None]] = None,
        on_progress: Optional[Callable[[dict], None]] = None,
        on_preview: Optional[Callable[[dict], None]] = None,
        max_events: int = 256,
    ) -> dict:
        """Drain the queues into callbacks; returns drained counts."""
        counts = {"log": 0, "progress": 0, "preview": 0}
        # Read the exit code BEFORE draining: if the process was already
        # dead when we started, everything it flushed is readable below,
        # so "drained everything + was dead + no sentinel" is race-free.
        exitcode_before = self.process.exitcode
        for _ in range(max_events):
            try:
                record = self.log_queue.get_nowait()
            except queue.Empty:
                break
            counts["log"] += 1
            message = (
                record.getMessage()
                if isinstance(record, logging.LogRecord)
                else str(record)
            )
            if message.startswith(ERROR_SENTINEL):
                self.failed = True
                message = message[len(ERROR_SENTINEL):]
            if on_log is not None:
                on_log(message)
        for _ in range(max_events):
            try:
                event = self.progress_queue.get_nowait()
            except queue.Empty:
                break
            counts["progress"] += 1
            if isinstance(event, tuple) and event and event[0] == "__done__":
                self.finished = True
                continue
            if isinstance(event, tuple) and event and event[0] == "__failed__":
                self.finished = True
                self.failed = True
                continue
            if on_progress is not None:
                on_progress(event)
        for _ in range(max_events):
            try:
                images = self.preview_queue.get_nowait()
            except queue.Empty:
                break
            counts["preview"] += 1
            if on_preview is not None:
                on_preview(images)
        # Hard worker death (OOM/segfault/spawn failure): the process is
        # gone but no __done__/__failed__ sentinel ever arrived.  Without
        # this, the GUI shows "running" forever (reference handles worker
        # death in _poll_worker_completion, user_interface_gui.py:1738).
        if not self.finished and exitcode_before is not None:
            self.finished = True
            self.failed = True
            if on_log is not None:
                on_log(
                    f"{self.step} worker died without completing "
                    f"(exit code {exitcode_before})."
                )
        return counts

    def stop(self) -> None:
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout=5)


class GuiSession:
    """Headless GUI core: step registry, workers, session cache.

    The session cache (versioned JSON) stores the ordered multi-file
    config set, the rig-class spec, the last step and flags, so
    relaunching the GUI restores the previous state (reference session
    cache + config manager, ``user_interface_gui.py:124-173,959-1005``).
    Config files deep-merge left-to-right, exactly as the CLI's repeated
    ``--config`` flags do.  Each step runs on the session's ``device``.
    """

    def __init__(self, cache_path: Optional[Path] = None, device=None) -> None:
        from .gui_support import default_session_cache_file, read_session_cache

        self.cache_path = (
            Path(cache_path)
            if cache_path is not None
            else default_session_cache_file()
        )
        #: Where the workers compute (None: the CUDA card); passed to each
        #: spawned worker as a string.
        self.device = None if device is None else str(device)
        self.state: dict = read_session_cache(self.cache_path)
        self.workers: list[WorkerHandle] = []

    # ------------------------------------------------------------ cache

    def load_cache(self) -> None:
        from .gui_support import read_session_cache

        self.state = read_session_cache(self.cache_path)

    def save_cache(self) -> None:
        from .gui_support import write_session_cache

        try:
            write_session_cache(self.cache_path, self.state)
        except OSError:
            logger.warning("Session cache not writable.")

    # ----------------------------------------------------------- configs

    @property
    def config_paths(self) -> list[str]:
        return list(self.state.get("config_paths", []))

    def set_config(self, config_path) -> None:
        """Replace the config set with one file (back-compat entry)."""
        self.set_configs([config_path])

    def set_configs(self, config_paths) -> None:
        from .gui_support import normalize_config_paths

        self.state["config_paths"] = [
            str(p) for p in normalize_config_paths(config_paths)
        ]
        self.save_cache()

    def add_config(self, config_path) -> bool:
        """Append one config overlay; returns False on duplicates."""
        from .gui_support import normalize_config_paths

        normalized = normalize_config_paths([config_path])
        if not normalized:
            return False
        path = str(normalized[0])
        if path in self.state.get("config_paths", []):
            return False
        self.state.setdefault("config_paths", []).append(path)
        self.save_cache()
        return True

    def remove_config(self, index: int) -> str:
        removed = self.state["config_paths"].pop(index)
        self.save_cache()
        return removed

    def move_config(self, index: int, delta: int) -> int:
        from .gui_support import move_item

        new_index = move_item(self.state["config_paths"], index, delta)
        self.save_cache()
        return new_index

    def set_rig_spec(self, spec: str) -> None:
        from .gui_support import resolve_rig_class

        resolve_rig_class(spec)  # fail fast on bad specs
        self.state["rig_spec"] = spec
        self.save_cache()

    def dashboard(self) -> list[str]:
        from .gui_support import dashboard_lines

        return dashboard_lines(
            self.config_paths, self.state.get("rig_spec", "")
        )

    def results_folder(self, step: str):
        from .gui_support import results_folder_for_step

        return results_folder_for_step(step, self.config_paths)

    # ----------------------------------------------------------- workers

    @property
    def steps(self) -> list:
        return list(STEP_REGISTRY)

    def step_parameters(self, step: str):
        """Form fields for a step (per-step parameter forms)."""
        from .gui_support import step_parameters

        return step_parameters(step)

    def start_step(
        self,
        step: str,
        config_path=None,
        all_images: Optional[bool] = None,
        options: Optional[dict] = None,
    ) -> WorkerHandle:
        if step not in STEP_REGISTRY:
            raise KeyError(f"Unknown step {step!r}; known: {self.steps}")
        if config_path is None:
            configs = self.config_paths
        elif isinstance(config_path, (list, tuple)):
            configs = [str(p) for p in config_path]
        else:
            configs = [str(config_path)]
        if not configs:
            raise ValueError("No config selected.")
        module_name, function_name, kind = STEP_REGISTRY[step]
        from .gui_support import validate_options

        validated = validate_options(step, options)
        if all_images is None and options is not None and "all_images" in options:
            all_images = validated["all_images"]
        step_kwargs = {
            k: v for k, v in validated.items() if k != "all_images"
        }
        all_flag = (
            self.state.get("all_images", False)
            if all_images is None
            else bool(all_images)
        )
        # A forked child cannot use CUDA: the workers are spawned.
        ctx = mp.get_context("spawn")
        log_queue: mp.Queue = ctx.Queue()
        progress_queue: mp.Queue = ctx.Queue()
        preview_queue: mp.Queue = ctx.Queue()
        process = ctx.Process(
            target=_worker,
            args=(
                module_name, function_name, kind, configs, all_flag,
                log_queue, progress_queue, preview_queue, self.device,
                step_kwargs, self.state.get("rig_spec", ""),
            ),
            daemon=True,
        )
        process.start()
        handle = WorkerHandle(
            step=step,
            process=process,
            log_queue=log_queue,
            progress_queue=progress_queue,
            preview_queue=preview_queue,
        )
        self.workers.append(handle)
        self.state["last_step"] = step
        self.state.setdefault("history", []).append(
            {"step": step, "config": configs, "started_at": handle.started_at}
        )
        self.state["history"] = self.state["history"][-50:]
        self.save_cache()
        return handle

    def stop_all(self) -> None:
        for handle in self.workers:
            handle.stop()


def run_step_in_worker(step: str, config_path: str, device=None):
    """Spawn a step, return (process, log_queue)."""
    import tempfile

    cache = Path(tempfile.gettempdir()) / "darsia_tpu_torch_gui_compat.json"
    session = GuiSession(cache_path=cache, device=device)
    handle = session.start_step(step, config_path)
    return handle.process, handle.log_queue


# --------------------------------------------------------------------- Tk


def launch_gui(
    config_path=None, session=None, root=None, run_mainloop: bool = True
):
    """Tk shell over :class:`GuiSession`: multi-config manager, built-in
    TOML editor, step buttons with per-step option forms, batch monitor
    with rolling ETA, log pane, streamed preview images, and done/error
    dialogs (reference GUI feature set, ``user_interface_gui.py``).

    ``session``/``root`` allow embedding (:class:`WorkflowGUI` passes its
    own); with ``run_mainloop=False`` the built root is returned instead
    of entering the Tk event loop."""
    try:
        import tkinter as tk
        from tkinter import filedialog, messagebox, scrolledtext, ttk
    except Exception as e:
        raise RuntimeError(
            "Tkinter is not available in this environment. Use the CLI "
            "front-ends instead, e.g. python -m "
            "darsia_tpu_torch.presets.workflows.user_interface_analysis "
            "--config config.toml --mass"
        ) from e

    from .gui_support import (
        BatchMonitor,
        ConfigEditorModel,
        PreviewStore,
        completion_dialog,
        new_config_from_template,
        open_in_file_explorer,
        step_parameters,
    )

    session = session if session is not None else GuiSession()
    if config_path is not None:
        if isinstance(config_path, (list, tuple)):
            session.set_configs(config_path)
        else:
            session.set_config(config_path)

    if root is None:
        try:
            root = tk.Tk()
        except tk.TclError as err:
            raise RuntimeError(f"{what} needs a display: {err}") from err
    root.title("darsia_tpu_torch workflows")

    # --- Config manager pane: ordered overlay list + rig spec. ---------
    manager_frame = tk.LabelFrame(root, text="Config files (merge top to bottom)")
    manager_frame.pack(fill="x")
    config_list = tk.Listbox(manager_frame, height=4, selectmode="browse")
    config_list.grid(row=0, column=0, rowspan=5, sticky="nsew")
    manager_frame.columnconfigure(0, weight=1)
    all_var = tk.BooleanVar(value=bool(session.state.get("all_images")))
    rig_var = tk.StringVar(value=session.state.get("rig_spec", ""))
    dashboard_box = tk.Label(
        manager_frame, justify="left", anchor="nw", relief="sunken"
    )
    dashboard_box.grid(row=0, column=2, rowspan=5, sticky="nsew")
    manager_frame.columnconfigure(2, weight=1)

    def refresh_configs() -> None:
        config_list.delete(0, tk.END)
        for path in session.config_paths:
            config_list.insert(tk.END, path)
        dashboard_box.configure(text="\n".join(session.dashboard()))

    def selected_index():
        selection = config_list.curselection()
        return selection[0] if selection else None

    def add_config() -> None:
        chosen = filedialog.askopenfilename(filetypes=[("TOML", "*.toml")])
        if chosen:
            if not session.add_config(chosen):
                messagebox.showinfo("Config", "Already in the list.")
            refresh_configs()

    def remove_config() -> None:
        index = selected_index()
        if index is not None:
            session.remove_config(index)
            refresh_configs()

    def move_config(delta: int) -> None:
        index = selected_index()
        if index is not None:
            new_index = session.move_config(index, delta)
            refresh_configs()
            config_list.selection_set(new_index)

    def new_from_template() -> None:
        dest = filedialog.asksaveasfilename(
            defaultextension=".toml", filetypes=[("TOML", "*.toml")]
        )
        if not dest:
            return
        try:
            created = new_config_from_template(dest)
        except FileExistsError as exc:
            messagebox.showerror("Template", str(exc))
            return
        session.add_config(created)
        refresh_configs()
        open_editor(created)

    # --- Built-in TOML editor (separate window). ------------------------
    def open_editor(path=None) -> None:
        index = selected_index()
        if path is None and index is not None:
            path = session.config_paths[index]
        if path is None:
            messagebox.showinfo("Editor", "Select a config file first.")
            return
        model = ConfigEditorModel()
        try:
            model.open(path)
        except OSError as exc:
            messagebox.showerror("Editor", str(exc))
            return
        window = tk.Toplevel(root)
        window.title(f"Edit {path}")
        editor = scrolledtext.ScrolledText(window, width=100, height=36)
        editor.pack(fill="both", expand=True)
        editor.insert("1.0", model.text)

        def do_save(save_as: bool = False) -> None:
            model.set_text(editor.get("1.0", tk.END)[:-1])
            target = model.path
            if save_as:
                chosen = filedialog.asksaveasfilename(
                    defaultextension=".toml", filetypes=[("TOML", "*.toml")]
                )
                if not chosen:
                    return
                target = chosen
            try:
                saved = model.save_as(target)
            except ValueError as exc:  # TOML syntax error
                messagebox.showerror("Save failed", str(exc))
                return
            window.title(f"Edit {saved}")
            refresh_configs()

        bar = tk.Frame(window)
        bar.pack(fill="x")
        tk.Button(bar, text="Save", command=do_save).pack(side="left")
        tk.Button(
            bar, text="Save as...", command=lambda: do_save(save_as=True)
        ).pack(side="left")

    column = tk.Frame(manager_frame)
    column.grid(row=0, column=1, rowspan=5, sticky="ns")
    for label, command in (
        ("Add...", add_config),
        ("Remove", remove_config),
        ("Up", lambda: move_config(-1)),
        ("Down", lambda: move_config(1)),
        ("New from template", new_from_template),
        ("Edit...", open_editor),
    ):
        tk.Button(column, text=label, command=command).pack(fill="x")

    options_bar = tk.Frame(root)
    options_bar.pack(fill="x")
    tk.Label(options_bar, text="Rig class (module:Class):").pack(side="left")
    rig_entry = tk.Entry(options_bar, textvariable=rig_var, width=48)
    rig_entry.pack(side="left")

    def apply_rig_spec(_event=None) -> None:
        try:
            session.set_rig_spec(rig_var.get())
        except (ValueError, ImportError) as exc:
            messagebox.showerror("Rig class", str(exc))

    rig_entry.bind("<FocusOut>", apply_rig_spec)
    rig_entry.bind("<Return>", apply_rig_spec)
    tk.Checkbutton(
        options_bar, text="all images", variable=all_var
    ).pack(side="right")

    buttons = tk.Frame(root)
    buttons.pack(fill="x")
    form_frame = tk.LabelFrame(root, text="Step options")
    form_frame.pack(fill="x")
    form_vars: dict = {}
    selected_step = tk.StringVar(value="")

    def build_form(step: str) -> None:
        """Render the step's parameter form (gui_support registry)."""
        for child in form_frame.winfo_children():
            child.destroy()
        form_vars.clear()
        selected_step.set(step)
        for col, spec in enumerate(step_parameters(step)):
            if spec.type == "bool":
                var = tk.BooleanVar(value=bool(spec.default))
                tk.Checkbutton(
                    form_frame, text=spec.label, variable=var
                ).grid(row=0, column=2 * col, columnspan=2, sticky="w")
            elif spec.type == "choice":
                var = tk.StringVar(
                    value="" if spec.default is None else str(spec.default)
                )
                tk.Label(form_frame, text=spec.label).grid(
                    row=0, column=2 * col, sticky="w"
                )
                ttk.Combobox(
                    form_frame, textvariable=var, state="readonly",
                    values=list(spec.choices), width=12,
                ).grid(row=0, column=2 * col + 1, sticky="w")
            else:
                var = tk.StringVar(
                    value="" if spec.default is None else str(spec.default)
                )
                tk.Label(form_frame, text=spec.label).grid(
                    row=0, column=2 * col, sticky="w"
                )
                tk.Entry(form_frame, textvariable=var, width=12).grid(
                    row=0, column=2 * col + 1, sticky="w"
                )
            form_vars[spec.name] = var

    progress = ttk.Progressbar(root, maximum=1.0)
    progress.pack(fill="x")
    status_bar = tk.Frame(root)
    status_bar.pack(fill="x")
    status_var = tk.StringVar(value="idle")
    tk.Label(status_bar, textvariable=status_var, anchor="w").pack(
        side="left", fill="x", expand=True
    )

    def abort_workers() -> None:
        if not session.workers:
            return
        if messagebox.askyesno("Abort", "Terminate the running step?"):
            session.stop_all()
            status_var.set("aborted")

    tk.Button(status_bar, text="Abort", command=abort_workers).pack(
        side="right"
    )
    monitor = BatchMonitor()
    previews = PreviewStore()
    error_lines: list[str] = []

    log_box = scrolledtext.ScrolledText(root, width=110, height=20)
    log_box.pack(fill="both", expand=True)
    preview_bar = tk.Frame(root)
    preview_bar.pack(fill="x")
    preview_key = tk.StringVar(value="")
    preview_menu = ttk.Combobox(
        preview_bar, textvariable=preview_key, state="readonly", width=40
    )
    preview_menu.pack(side="left")
    preview_label = tk.Label(root)
    preview_label.pack()
    preview_ref = {"image": None}

    def log(message: str) -> None:
        log_box.insert(tk.END, message + "\n")
        log_box.see(tk.END)
        if "failed:" in message or "Error" in message:
            error_lines.append(message)

    def on_progress(event) -> None:
        if isinstance(event, dict):
            monitor.update(event)
            progress["value"] = monitor.percent() / 100.0
            status_var.set(monitor.text())

    def render_preview() -> None:
        try:
            key = preview_key.get()
            if key and key in previews.keys():
                previews.select(key)
            arr = previews.as_display()
            if arr is None:
                return
            height, width = arr.shape[:2]
            photo = tk.PhotoImage(width=width, height=height)
            rows = "{" + "} {".join(
                " ".join(
                    f"#{r:02x}{g:02x}{b:02x}" for r, g, b in row
                )
                for row in arr
            ) + "}"
            photo.put(rows)
            preview_label.configure(image=photo)
            preview_ref["image"] = photo
        except Exception:
            pass

    def on_preview(images: dict) -> None:
        previews.update(images)
        preview_menu["values"] = previews.keys()
        if not preview_key.get() and previews.selected:
            preview_key.set(previews.selected)
        render_preview()

    preview_menu.bind("<<ComboboxSelected>>", lambda _e: render_preview())

    def show_completion(handle) -> None:
        """Done/error dialog with details + open-results-folder."""
        elapsed = time.time() - handle.started_at
        results = session.results_folder(handle.step)
        spec = completion_dialog(
            handle.step,
            failed=handle.failed,
            elapsed_s=elapsed,
            error="\n".join(error_lines[-12:]),
            results_folder=str(results) if results else None,
        )
        if handle.failed:
            messagebox.showerror(
                spec["title"],
                spec["message"]
                + ("\n\n" + spec.get("details", "") if spec.get("details") else ""),
            )
        elif spec.get("results_folder") and messagebox.askyesno(
            spec["title"], spec["message"] + "\n\nOpen results folder?"
        ):
            open_in_file_explorer(spec["results_folder"])
        else:
            messagebox.showinfo(spec["title"], spec["message"])

    def poll() -> None:
        for handle in list(session.workers):
            handle.poll(on_log=log, on_progress=on_progress,
                        on_preview=on_preview)
            if handle.finished and not handle.alive():
                status_var.set(
                    f"{handle.step} "
                    + ("FAILED" if handle.failed else "finished")
                )
                session.workers.remove(handle)
                show_completion(handle)
                error_lines.clear()
        root.after(250, poll)

    def start(step: str) -> None:
        session.state["all_images"] = bool(all_var.get())
        options = {"all_images": bool(all_var.get())}
        if selected_step.get() == step:
            for name, var in form_vars.items():
                options[name] = var.get()
        error_lines.clear()
        try:
            handle = session.start_step(step, options=options)
        except (KeyError, ValueError) as exc:
            log(str(exc))
            return
        log(f"Started {step} (pid {handle.process.pid}).")

    def select_and_start(step: str) -> None:
        if selected_step.get() != step:
            build_form(step)  # first click shows the form
            return
        start(step)

    for i, step in enumerate(STEP_REGISTRY):
        tk.Button(
            buttons, text=step, command=lambda s=step: select_and_start(s)
        ).grid(row=i // 5, column=i % 5, sticky="ew")

    refresh_configs()
    poll()
    root.protocol("WM_DELETE_WINDOW", lambda: (session.stop_all(), root.destroy()))
    if not run_mainloop:
        return root
    root.mainloop()


class QueueLogHandler(logging.Handler):
    """Log handler forwarding formatted records into a queue for GUI
    consumption (reference ``user_interface_gui.py:846-855``)."""

    def __init__(self, queue: "SupportsLogQueue") -> None:
        super().__init__()
        self._queue = queue

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._queue.put(self.format(record))
        except Exception:  # queue closed mid-shutdown; never raise from logging
            pass


@dataclass
class RunContext:
    """Resolved launch inputs for one worker run (reference
    ``user_interface_gui.py:858-861``)."""

    config_paths: list
    rig_cls: type = None


class WorkflowGUI:
    """Tkinter GUI for preset workflow execution (reference
    ``user_interface_gui.py:863+``).

    The widget tree, polling loops and worker lifecycle are delegated to
    :func:`launch_gui` over the shared headless :class:`GuiSession`; the
    class owns the session, the log queue + :class:`QueueLogHandler`
    wiring, and the Tk root."""

    def __init__(self, root=None, config_path=None) -> None:
        self.session = GuiSession()
        self.log_queue: "queue.Queue" = queue.Queue()
        self._log_handler = QueueLogHandler(self.log_queue)
        logging.getLogger("darsia_tpu_torch").addHandler(self._log_handler)
        self.root = launch_gui(
            config_path=config_path,
            session=self.session,
            root=root,
            run_mainloop=False,
        )

    def run(self) -> None:
        """Enter the Tk event loop."""
        self.root.mainloop()

    def close(self) -> None:
        """Stop workers, detach logging, and destroy the window."""
        self.session.stop_all()
        logging.getLogger("darsia_tpu_torch").removeHandler(self._log_handler)
        try:
            self.root.destroy()
        except Exception:
            pass


def main(argv=None) -> None:
    configs = list(argv) if argv else sys.argv[1:]
    launch_gui(configs or None)


if __name__ == "__main__":
    main()
