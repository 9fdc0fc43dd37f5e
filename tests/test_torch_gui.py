"""The port's workflow GUI core against the JAX package's.

Mirrors ``tests/unit/test_gui_helpers.py``, ``test_gui_support.py`` and
``test_gui_session.py``: the pure helpers, the forms, the batch monitor,
the preview store, the config set, the session cache, the editor and the
dialogs give the JAX package's results on the same inputs (exactly; the
texts that name the package differ only in its name).  The session's queue
protocol is driven with fake processes; the registry names callables of
the port (the JAX registry's set-up entries are ROADMAP Queue 3 fault 30).
Three spawned workers run on ``device="cpu"``: one fails on a bad config
and reports it over the queue, one is stopped, and one runs
``"analysis: mass"`` on the analysis workspace of
``tests/test_torch_analysis_workflow.py`` to ``__done__``, with one
progress event per photograph, PNG previews and the CSV of the same step
run in this process.
"""

import dataclasses
import importlib
import inspect
import logging
import multiprocessing as mp
import queue
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from darsia_tpu.presets.workflows import gui_helpers as jgh
from darsia_tpu.presets.workflows import gui_support as jgs
from darsia_tpu_torch.presets.workflows import gui_helpers as gh
from darsia_tpu_torch.presets.workflows import gui_support as gs
from darsia_tpu_torch.presets.workflows.user_interface_gui import (
    ERROR_SENTINEL,
    STEP_REGISTRY,
    GuiSession,
    WorkerHandle,
)

torch.set_num_threads(1)

#: A spawned worker imports torch and the port before it runs its step.
WORKER_DEADLINE_S = 120


def _same(name, *args, **kwargs):
    """``name`` of the port's gui_helpers and of the JAX package's on the
    same arguments."""
    got = getattr(gh, name)(*args, **kwargs)
    want = getattr(jgh, name)(*args, **kwargs)
    assert got == want, (name, got, want)
    return got


HELPER_CASES = [
    ("normalize_paths", (["/a/x.toml", "  ", "/a/x.toml", "/b.toml"],), {}),
    ("deduplicate_paths", ([Path("x"), Path("x"), Path("y")],), {}),
    ("encode_workflow_error_details", ("Traceback ...",), {}),
    ("decode_workflow_error_details", (jgh.WORKFLOW_ERROR_DETAILS_PREFIX + "tb",), {}),
    ("decode_workflow_error_details", ("INFO: hi",), {}),
    ("format_error_details_text", ("  boom  ",), {}),
    ("format_error_details_text", ("  ",), {}),
    ("format_duration_seconds", (3723,), {}),
    ("format_duration_seconds", (75,), {}),
    ("format_duration_seconds", (None,), {}),
    ("format_duration_seconds", (float("nan"),), {}),
    ("format_duration_seconds", (True,), {}),
    ("rolling_average_runtime", ([10.0, 2.0, 4.0],), {"max_samples": 2}),
    ("rolling_average_runtime", ([0.0, -1.0],), {}),
    ("remaining_image_count", (12, 10), {}),
    ("estimate_remaining_time_seconds", (2.0, 4, 10), {}),
    ("estimate_remaining_time_seconds", (2.0, 1, 10), {}),
    ("progress_percent", (15, 10), {}),
    (
        "format_batch_monitor_text",
        (),
        {"step": "mass", "image_path": "img.jpg", "processed": 2, "total": 8, "last_image_seconds": 1.2, "eta_seconds": 7.5},
    ),
    ("enabled_option_labels", ({"export_bundle": True, "media": False, "download": True},), {"exclude": {"download"}}),
    ("map_conflict_dialog_choice_to_policy", (True,), {}),
    ("map_conflict_dialog_choice_to_policy", (None,), {}),
    ("format_workflow_done_message", ("analysis", [], 2, 1.25), {}),
    ("format_workflow_error_message", ("setup", ["rig"], 3), {}),
    ("completion_dialog_spec", ("analysis", 2, False), {}),
    ("completion_dialog_spec", ("analysis", 1, True), {}),
    ("abort_process", (None,), {}),
]


@pytest.mark.parametrize("name,args,kwargs", HELPER_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(HELPER_CASES)])
def test_helpers_match_the_jax_package(name, args, kwargs):
    _same(name, *args, **kwargs)


def test_queue_hygiene_and_start_message():
    q = queue.Queue()
    for item in ("old1", "old2"):
        q.put(item)
    gh.publish_latest_queue_item(q, "new")
    assert q.get_nowait() == "new" and q.empty()
    gh.clear_queue(q)
    got = gh.format_workflow_start_message("analysis", ["mass"], [Path("cfg.toml")], "")
    want = jgh.format_workflow_start_message("analysis", ["mass"], [Path("cfg.toml")], "")
    assert got == want.replace("darsia_tpu.", "darsia_tpu_torch.")


def _config(tmp_path, extra: str = "") -> Path:
    cfg = tmp_path / "config.toml"
    cfg.write_text("\n".join(["[data]", f'results = "{tmp_path / "results"}"', extra]))
    return cfg


SUGGESTIONS = [
    ("analysis", ["mass"], ""),
    ("analysis", ["mass", "volume"], ""),
    ("analysis", ["mass"], '[analysis.mass]\nfolder = "/elsewhere/override"'),
    ("analysis", ["fingers"], ""),
    ("setup", ["depth"], ""),
    ("setup", [], ""),
    ("calibration", [], ""),
    ("comparison", ["events"], ""),
    ("comparison", ["wasserstein compute"], ""),
    ("comparison", ["events", "wasserstein compute"], ""),
    ("comparison", [], ""),
    ("comparison", ["wasserstein compute"], '[wasserstein]\nresults = "/elsewhere/w1"'),
    ("comparison", ["events"], '[events]\npath = "/elsewhere/ev/events.csv"'),
    ("utils", ["media"], ""),
    ("utils", ["export calibration", "import calibration"], ""),
    ("utils", ["media", "download"], ""),
    ("utils", [], ""),
    ("utils", ["download"], '[download]\nfolder = "/elsewhere/dl"'),
    ("helper", [], ""),
]


@pytest.mark.parametrize("workflow,actions,extra", SUGGESTIONS)
def test_folder_suggestions_match_the_jax_package(workflow, actions, extra, tmp_path):
    cfg = _config(tmp_path, extra)
    got = _same("suggested_workflow_results_folder", workflow, [cfg], actions)
    if workflow == "analysis":
        assert got == _same("suggested_analysis_results_folder", [cfg], actions)
    empty = tmp_path / "empty.toml"
    empty.write_text("[data]\n")
    assert gh.suggested_analysis_results_folder([empty], ["mass"]) is None


def test_utils_bundle_defaults_and_abort(tmp_path):
    cfg = tmp_path / "config.toml"
    cfg.write_text('[utils]\nexport_calibration_bundle = "/elsewhere/out.zip"\n')
    assert _same("resolve_utils_bundle_defaults", [str(cfg)]) == ("/elsewhere/out.zip", "")
    assert gh.resolve_utils_bundle_defaults([]) == ("", "")

    class Dead:
        def is_alive(self):
            return False

    assert gh.abort_process(Dead()) is False
    process = mp.get_context("spawn").Process(target=time.sleep, args=(30,))
    process.start()
    try:
        assert gh.abort_process(process) is True and not process.is_alive()
    finally:
        if process.is_alive():
            process.kill()


# ------------------------------------------------------------- gui_support


def _overlays(tmp_path):
    base = tmp_path / "base.toml"
    base.write_text(
        '[data]\nimages = "imgs"\nbaseline = ["b.jpg"]\nresults = "%s"\n'
        "[analysis.mass]\nrois = []\n" % (tmp_path / "results")
    )
    override = tmp_path / "override.toml"
    override.write_text('[analysis.mass]\nfolder = "%s"\n' % (tmp_path / "custom_mass"))
    return base, override


def test_paths_items_and_config_manager(tmp_path):
    raw = ["/a/b.toml", "  ", "/a/b.toml", "/c.toml"]
    assert gs.normalize_config_paths(raw) == jgs.normalize_config_paths(raw) == [Path("/a/b.toml"), Path("/c.toml")]
    a, b = Path("/x"), Path("/y")
    assert gs.deduplicate_paths([a, b, a, b]) == [a, b]
    for module in (gs, jgs):
        items = ["a", "b", "c"]
        assert module.move_item(items, 2, -1) == 1 and items == ["a", "c", "b"]
        assert module.move_item(items, 0, -5) == 0 and module.move_item(items, 2, 9) == 2
        for bad in ((items, 7, 1), ([], 0, 1)):
            with pytest.raises(IndexError):
                module.move_item(*bad)
    base, override = _overlays(tmp_path)
    port, jax = gs.ConfigManager([base, override]), jgs.ConfigManager([base, override])
    assert port.merged() == jax.merged()
    assert port.results_folder() == jax.results_folder() == tmp_path / "results"
    manager = gs.ConfigManager()
    assert manager.add(base) is True and manager.add(base) is False
    manager.add(override)
    assert manager.move(1, -1) == 0 and manager.remove(0) == override.resolve()
    assert manager.as_strings() == [str(base.resolve())]
    assert gs.utils_bundle_defaults([base]) == jgs.utils_bundle_defaults([base])
    assert gs.utils_bundle_defaults([]) == ("", "")


@pytest.mark.parametrize(
    "step",
    ["analysis: mass", "analysis: fingers", "setup: rig", "utils: media", "comparison: wasserstein",
     "calibration: color paths", "helper: color report", "utils: export calibration bundle"],
)
def test_results_folder_for_step_matches_the_jax_package(step, tmp_path):
    base, override = _overlays(tmp_path)
    for configs in ([base], [base, override], ["/nonexistent.toml"]):
        assert gs.results_folder_for_step(step, configs) == jgs.results_folder_for_step(step, configs)


def test_rig_class_resolution():
    from darsia_tpu_torch.presets.workflows.rig import Rig

    assert gs.resolve_rig_class("") is Rig
    assert gs.resolve_rig_class("darsia_tpu_torch.presets.workflows.rig:Rig") is Rig
    for spec, match in (
        ("not-a-spec", "module.path:ClassName"),
        ("darsia_tpu_torch.presets.workflows.rig:NoSuchRig", "not found"),
        ("pathlib:Path", "not a subclass"),
        ("darsia_tpu.presets.workflows.rig:Rig", "not a subclass"),
    ):
        with pytest.raises(ValueError, match=match):
            gs.resolve_rig_class(spec)


def test_session_cache_files(tmp_path):
    state = {
        "config_paths": ["/a.toml", "/b.toml"],
        "rig_spec": "darsia_tpu_torch.presets.workflows.rig:Rig",
        "last_step": "analysis: mass",
        "all_images": True,
        "history": [{"step": "analysis: mass"}],
    }
    gs.write_session_cache(tmp_path / "p.json", state)
    jgs.write_session_cache(tmp_path / "j.json", state)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert gs.read_session_cache(tmp_path / "p.json") == jgs.read_session_cache(tmp_path / "p.json")
    for text in ('{"config": "/legacy/config.toml", "all_images": true}', "{not json", "[1, 2, 3]"):
        (tmp_path / "c.json").write_text(text)
        assert gs.read_session_cache(tmp_path / "c.json") == jgs.read_session_cache(tmp_path / "c.json")
    assert gs.default_session_cache_file().parts[-2:] == ("darsia_tpu_torch", "gui_session.json")


def test_editor_template_dashboard_and_dialogs(tmp_path):
    target = tmp_path / "c.toml"
    target.write_text('[data]\nimages = "x"\n')
    model = gs.ConfigEditorModel()
    model.open(target)
    model.set_text('[data]\nimages = "y"\n')
    assert model.dirty and model.save() == target and not model.dirty
    model.set_text("not = valid = toml")
    with pytest.raises(ValueError, match="not valid TOML"):
        model.save_as(tmp_path / "out.toml")
    with pytest.raises(ValueError, match="No file open"):
        gs.ConfigEditorModel().save()
    created = gs.new_config_from_template(tmp_path / "fresh.toml")
    assert created.read_text() == gs.template_config_path().read_text()
    with pytest.raises(FileExistsError):
        gs.new_config_from_template(created)
    base, override = _overlays(tmp_path)
    for configs in ([base, override], [], [tmp_path / "missing.toml"]):
        got = gs.dashboard_lines(configs, rig_spec="")
        want = jgs.dashboard_lines(configs, rig_spec="")
        assert got == [line.replace("darsia_tpu default", "darsia_tpu_torch default") for line in want]
    payload = gs.encode_error_details("step failed: boom", "Traceback ...")
    assert payload == jgs.encode_error_details("step failed: boom", "Traceback ...")
    assert gs.decode_error_details(payload) == ("step failed: boom", "Traceback ...")
    assert [gs.conflict_choice_to_policy(c) for c in (True, False, None)] == ["overwrite", "skip", None]
    for args in (("analysis: mass", False, 65, "", "/r"), ("analysis: mass", True, None, "Boom\ntraceback...")):
        assert gs.completion_dialog(*args) == jgs.completion_dialog(*args)
    calls = []
    command = gs.open_in_file_explorer(tmp_path / "does" / "not" / "exist", runner=calls.append)
    assert calls == [command] and command[-1] == str(tmp_path)


def test_forms_and_batch_monitor():
    for step in ("analysis: mass", "analysis: fingers", "comparison: wasserstein"):
        got = [dataclasses.astuple(p) for p in gs.step_parameters(step)]
        assert got == [dataclasses.astuple(p) for p in jgs.step_parameters(step)]
    for step, options in (("analysis: fingers", {"write_plots": "false"}), ("comparison: wasserstein", {"mode": "assemble"})):
        assert gs.validate_options(step, options) == jgs.validate_options(step, options)
    with pytest.raises(KeyError, match="bogus"):
        gs.validate_options("analysis: mass", {"bogus": 1})
    with pytest.raises(ValueError):
        gs.validate_options("comparison: wasserstein", {"mode": "neither"})
    monitors = (gs.BatchMonitor(window=3), jgs.BatchMonitor(window=3))
    events = [{"event": "step_start", "step": "mass", "image_total": 10}] + [
        {"event": "image_progress", "image_index": i, "image_total": 10, "image_duration_s": d}
        for i, d in enumerate([30.0, 2.0, 2.0, 2.0], start=1)
    ] + [{"event": "step_complete"}]
    for event in events:
        texts = []
        for monitor in monitors:
            monitor.update(event)
            texts.append((monitor.text(), monitor.eta_seconds(), monitor.percent()))
        assert texts[0] == texts[1]
    assert gs.format_duration(3725) == "01:02:05" and gs.format_duration(None) == "--:--:--"


def test_preview_store_display():
    big = np.linspace(0, 1, 1000 * 600).reshape(1000, 600).astype(np.float32)
    small = np.ones((8, 8, 3))
    port, jax = gs.PreviewStore(), jgs.PreviewStore()
    assert port.as_display() is None
    port.update({"segmentation": torch.from_numpy(big), "mass": small})
    jax.update({"segmentation": big, "mass": small})
    assert port.keys() == jax.keys() == ["segmentation", "mass"] and port.selected == "segmentation"
    got = port.as_display(max_size=480)
    assert got.dtype == np.uint8 and got.shape[-1] == 3 and np.array_equal(got, jax.as_display(max_size=480))
    port.select("mass")
    assert port.as_display().shape == (8, 8, 3)
    with pytest.raises(KeyError):
        port.select("nothing")


# ------------------------------------------------------------- the session


def test_registry_names_callables_of_the_port():
    from darsia_tpu.presets.workflows.user_interface_gui import STEP_REGISTRY as JAX_REGISTRY

    assert list(STEP_REGISTRY) == list(JAX_REGISTRY)
    families = {step.split(":")[0] for step in STEP_REGISTRY}
    assert families == {"setup", "calibration", "analysis", "comparison", "helper", "utils"}
    for step, (module, function, kind) in STEP_REGISTRY.items():
        assert module.startswith("darsia_tpu_torch.") and kind == JAX_REGISTRY[step][2]
        target = getattr(importlib.import_module(module), function)
        assert inspect.isfunction(target), step
        params = inspect.signature(target).parameters
        assert ("path" in params) if kind == "config" else True, step


def test_session_cache_and_configs(tmp_path):
    cache = tmp_path / "session.json"
    session = GuiSession(cache_path=cache, device="cpu")
    assert session.device == "cpu"
    session.set_config("/some/config.toml")
    session.state["all_images"] = True
    session.save_cache()
    restored = GuiSession(cache_path=cache)
    assert restored.config_paths == ["/some/config.toml"] and restored.state["all_images"] is True
    assert session.add_config("/two.toml") is True and session.add_config("/two.toml") is False
    assert session.move_config(1, -1) == 0 and session.config_paths == ["/two.toml", "/some/config.toml"]
    assert session.remove_config(0) == "/two.toml"
    session.set_rig_spec("darsia_tpu_torch.presets.workflows.rig:Rig")
    with pytest.raises(ValueError):
        session.set_rig_spec("bogus")
    assert session.dashboard()[0] == "Config files: 1"
    with pytest.raises(KeyError):
        session.start_step("nonsense step")
    with pytest.raises(KeyError, match="bogus"):
        session.start_step("analysis: mass", options={"bogus": True})
    with pytest.raises(ValueError):
        GuiSession(cache_path=tmp_path / "empty.json").start_step("analysis: mass")


class _DeadProcess:
    pid = -1

    def __init__(self, exitcode):
        self.exitcode = exitcode

    def is_alive(self):
        return False

    def terminate(self):
        pass

    def join(self, timeout=None):
        pass


def _handle(exitcode):
    ctx = mp.get_context("spawn")
    return WorkerHandle("analysis: mass", _DeadProcess(exitcode), ctx.Queue(), ctx.Queue(), ctx.Queue())


def test_poll_drains_queues_and_flags_errors():
    handle = _handle(0)
    handle.log_queue.put(logging.makeLogRecord({"msg": "hello"}))
    handle.log_queue.put(logging.makeLogRecord({"msg": ERROR_SENTINEL + "step crashed"}))
    handle.progress_queue.put({"event": "image_progress", "image_index": 1, "image_total": 4})
    handle.progress_queue.put(("__done__", "analysis_mass_from_context"))
    handle.preview_queue.put({"mass": b"png-bytes"})
    time.sleep(0.2)  # the queues' feeder threads flush
    logs, events, previews = [], [], []
    counts = handle.poll(on_log=logs.append, on_progress=events.append, on_preview=previews.append)
    assert counts == {"log": 2, "progress": 2, "preview": 1}
    assert logs == ["hello", "step crashed"] and handle.failed and handle.finished
    assert events == [{"event": "image_progress", "image_index": 1, "image_total": 4}]
    assert previews == [{"mass": b"png-bytes"}]
    dead = _handle(-9)
    logs = []
    dead.poll(on_log=logs.append)
    assert dead.finished and dead.failed and any("died without completing" in line for line in logs)


def _wait(handle, **callbacks):
    deadline = time.time() + WORKER_DEADLINE_S
    while time.time() < deadline:
        handle.poll(**callbacks)
        if handle.finished and not handle.alive():
            break
        time.sleep(0.1)
    handle.poll(**callbacks)


def test_worker_error_surfaces_and_stop_terminates(tmp_path):
    session = GuiSession(cache_path=tmp_path / "cache.json", device="cpu")
    bad = tmp_path / "bad.toml"
    bad.write_text("[data]\nfolder = '/nonexistent-folder-xyz'\n")
    session.set_config(bad)
    handle = session.start_step("analysis: mass", all_images=True)
    stopped = session.start_step("analysis: mass", all_images=True)
    stopped.stop()
    assert not stopped.alive()
    logs = []
    _wait(handle, on_log=logs.append)
    assert handle.finished and handle.failed and any("failed" in line for line in logs)
    session.stop_all()


def test_spawned_worker_runs_the_mass_step_on_the_cpu(tmp_path):
    from test_torch_analysis_workflow import write_workspace

    from darsia_tpu_torch.presets.workflows.analysis import analysis_mass_from_context, prepare_analysis_context
    import darsia_tpu_torch as dt

    _, configs = write_workspace(tmp_path, names=("here", "worker"))
    ctx = prepare_analysis_context(cls=dt.Rig, path=configs["here"], all=True, require_color_to_mass=True, device="cpu")
    analysis_mass_from_context(ctx)
    session = GuiSession(cache_path=tmp_path / "cache.json", device="cpu")
    session.set_config(configs["worker"])
    handle = session.start_step("analysis: mass", all_images=True)
    logs, events, previews = [], [], []
    _wait(handle, on_log=logs.append, on_progress=events.append, on_preview=previews.append)
    assert handle.finished and not handle.failed, logs
    progress = [e for e in events if e.get("event") == "image_progress"]
    assert [e["image_index"] for e in progress] == [1, 2, 3, 4]
    assert previews and all(isinstance(v, bytes) for p in previews for v in p.values())
    for payload in previews:
        for data in payload.values():
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
    here = sorted((tmp_path / "results_here").rglob("*.csv"))
    there = sorted((tmp_path / "results_worker").rglob("*.csv"))
    assert [p.name for p in here] == [p.name for p in there] and here
    for a, b in zip(here, there):
        assert a.read_text() == b.read_text()
