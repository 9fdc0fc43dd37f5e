"""The port keeps the JAX package's public names.

Every public name of ``darsia_tpu`` that some module of ``darsia_tpu_torch``
defines is reachable as ``darsia_tpu_torch.<name>``, and is the port's own
object, with no exception: the display and export layer (plots, VTK, the
DICOM and VTU readers) is ported too, and runs where its library imports.
The calibration, helper and utils workflow modules keep every name of the
JAX modules' ``__all__``; those that need OpenCV or matplotlib (media,
contours, plots) say so in their module's docstring, and raise naming the
library where it does not import.  Also the two signatures that ROADMAP Queue 3
fault P1 names: ``interpolate_measurements_2d`` takes JAX's two arguments
(the device defaults to the card), and
``load_curvature_correction_config_from_toml`` warns on a file without a
``[curvature]`` section as JAX's does.
"""

import __future__
import ast
import functools
import importlib
import inspect
import pkgutil
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

#: Public JAX names the port leaves out: none.
NOT_PORTABLE: set = set()


def public_jax_names() -> list:
    return [
        name
        for name in dir(da)
        if not name.startswith("_")
        and not isinstance(getattr(da, name), __future__._Feature)
    ]


def port_definitions() -> dict:
    """Every public module-level name of every module of the port -> the
    module that holds it."""
    defined = {}
    for info in pkgutil.walk_packages(dt.__path__, "darsia_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, value in vars(module).items():
            if name.startswith("_") or isinstance(value, __future__._Feature):
                continue
            defined.setdefault(name, module.__name__)
        defined.setdefault(info.name.rsplit(".", 1)[-1], info.name)
    return defined


def test_every_public_name_the_port_defines_is_exported():
    defined = port_definitions()
    names = [n for n in public_jax_names() if n in defined and n not in NOT_PORTABLE]
    assert len(names) > 250
    missing = [n for n in names if not hasattr(dt, n)]
    assert not missing, missing


def test_exported_names_are_the_ports_own():
    for name in public_jax_names():
        if not hasattr(dt, name):
            continue
        value = getattr(dt, name)
        if isinstance(value, types.ModuleType):
            assert value.__name__.startswith("darsia_tpu_torch."), name
        elif (inspect.isclass(value) or inspect.isfunction(value)) and value.__module__ != "builtins":
            # (A type alias such as ColorCheckerPosition = str is builtin;
            # Contour = np.ndarray is numpy's class in both packages.)
            if value is getattr(da, name) and not value.__module__.startswith("darsia_tpu"):
                continue
            assert value.__module__.startswith("darsia_tpu_torch"), (name, value.__module__)


@pytest.mark.parametrize(
    "name",
    [
        "ProtocolledExperiment",
        "FluidFlowerCO2Analysis",
        "FluidFlowerTracerAnalysis",
        "FluidFlowerRig",
        "ThresholdModel",
        "BinaryDataSelector",
        "HeterogeneousLinearModel",
        "segment",
        "kmeans",
        "manager",
        "Rig",
        "FaciesProps",
        "FluidFlowerConfig",
        "MultiFluidFlowerConfig",
        "ColorEmbeddingRuntime",
        "ColorChannelEmbedding",
        "ColorRangeEmbedding",
        "ColorPathEmbedding",
        "ColorSpectrum",
        "DiscreteColorRange",
        "LabelColorPathMap",
        "LabelColorPathMapRegression",
        "PorosityAnalysis",
        "patched_porosity_analysis",
        "KernelInterpolation",
        "GaussianKernel",
        "Masks",
        "validate_mode_syntax",
        "imread_from_bytes",
        "imread_from_optical",
        "EMD",
        "BaseAssistant",
        "PointSelectionAssistant",
        "BoxSelectionAssistant",
        "RectangleSelectionAssistant",
        "SubregionAssistant",
        "RotationCorrectionAssistant",
        "CropAssistant",
        "LabelsSegmentAssistant",
        "LabelsMaskSelectionAssistant",
        "LabelsPickAssistant",
        "LabelsMergeAssistant",
        "LabelsAssistant",
        "LabelsAssistantMenu",
        "MonochromaticAssistant",
    ],
)
def test_named_entry_points_are_exported(name):
    assert hasattr(dt, name) and hasattr(da, name)


def test_interpolate_measurements_2d_takes_jax_arguments():
    params = inspect.signature(dt.interpolate_measurements_2d).parameters
    assert list(params)[:2] == list(inspect.signature(da.interpolate_measurements_2d).parameters)
    assert params["device"].default is None
    cs = dt.CoordinateSystem(dt.Image(torch.zeros(6, 8), width=2.0, height=1.0, device="cpu"))
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 2, 12), rng.uniform(0, 1, 12)
    values = 1 + 0.5 * x - 0.2 * y
    out = dt.interpolate_measurements_2d((x, y, values), cs, "cpu")
    cs_j = da.CoordinateSystem(da.Image(np.zeros((6, 8)), width=2.0, height=1.0))
    ref = np.asarray(da.interpolate_measurements_2d((x, y, values), cs_j))
    assert np.abs(out.numpy() - ref).max() <= 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.interpolate_measurements_2d((x, y, values), cs)


def test_curvature_toml_loader_warns_like_jax(tmp_path):
    empty = tmp_path / "empty.toml"
    empty.write_text('[other]\nkey = 1\n')
    for pkg in (da, dt):
        with pytest.warns(UserWarning, match="curvature"):
            assert pkg.load_curvature_correction_config_from_toml(empty) == {}
    config = tmp_path / "config.toml"
    config.write_text(
        "[curvature.crop]\npts_src = [[1, 2], [30, 1], [31, 40], [2, 41]]\nwidth = 2.0\nheight = 1.0\n"
        "[curvature.bulge]\nhorizontal_bulge = -1e-6\n"
    )
    port = dt.load_curvature_correction_config_from_toml(config)
    ref = da.load_curvature_correction_config_from_toml(config)
    assert port["crop"]["width"] == ref["crop"]["width"] == 2.0
    np.testing.assert_array_equal(np.asarray(port["crop"]["pts_src"]), np.asarray(ref["crop"]["pts_src"]))
    assert port["bulge"]["horizontal_bulge"] == ref["bulge"]["horizontal_bulge"]


#: Workflow helpers that need a library the card's machine lacks (ROADMAP
#: Queue 1): they raise naming it where it does not import.
NEEDS_LIBRARY = {
    "utils.utils_media.build_media": "OpenCV",
    "utils.roi_visualization.render_active_region": "OpenCV",
    "utils.roi_visualization.draw_active_region": "matplotlib",
    "helper.helper_roi.helper_roi_viewer": "matplotlib",
    "helper.helper_roi.launch_roi_helper_viewer": "matplotlib",
    "helper.helper_roi.launch_roi_viewer": "matplotlib",
    "helper.helper_result_reader.launch_result_reader": "matplotlib",
    "analysis.analysis_segmentation.analysis_segmentation": "matplotlib",
    "analysis.analysis_segmentation.analysis_segmentation_from_context": "matplotlib",
    "analysis.analysis_thresholding.analysis_thresholding": "matplotlib",
    "analysis.analysis_thresholding.analysis_thresholding_from_context": "matplotlib",
}

WORKFLOW_MODULES = [
    "basis",
    "calibration.metadata",
    "calibration.calibration_color_paths",
    "calibration.calibration_color_to_mass_analysis",
    "calibration.legacy",
    "helper.helper_color",
    "helper.helper_result_reader",
    "helper.helper_roi",
    "utils.images",
    "utils.calibration_bundle",
    "utils.utils_download",
    "utils.utils_media",
    "utils.roi_visualization",
    "user_interface_calibration",
    "user_interface_helper",
    "user_interface_utils",
    "segmentation_contours",
    "analysis.analysis_fingers",
    "analysis.analysis_segmentation",
    "analysis.analysis_thresholding",
    "gui_helpers",
    "gui_support",
    "user_interface_gui",
]


@pytest.mark.parametrize("module", WORKFLOW_MODULES)
def test_workflow_modules_keep_the_jax_names(module):
    jax = importlib.import_module(f"darsia_tpu.presets.workflows.{module}")
    port = importlib.import_module(f"darsia_tpu_torch.presets.workflows.{module}")
    missing = [name for name in jax.__all__ if not hasattr(port, name)]
    assert not missing, missing
    for name in jax.__all__:
        key = f"{module}.{name}"
        if key in NEEDS_LIBRARY:
            assert NEEDS_LIBRARY[key] in (port.__doc__ or ""), key


@pytest.mark.parametrize("package", ["calibration", "helper", "utils"])
def test_workflow_packages_export_the_jax_names(package):
    jax = importlib.import_module(f"darsia_tpu.presets.workflows.{package}")
    port = importlib.import_module(f"darsia_tpu_torch.presets.workflows.{package}")
    names = [n for n in dir(jax) if not n.startswith("_") and not isinstance(getattr(jax, n), types.ModuleType)]
    assert names and not [n for n in names if not hasattr(port, n)]
    workflows = importlib.import_module("darsia_tpu_torch.presets.workflows")
    assert getattr(workflows, package) is port


@pytest.mark.parametrize(
    "name",
    [
        "imread_from_dicom",
        "imread_from_vtu",
        "plotting",
        "augmented_plotting",
        "plot_contour_on_image",
        "plot_distribution_on_image",
        "plot_image_statistics",
        "to_vtk",
        "wasserstein_distance_to_vtk",
    ],
)
def test_display_and_export_names_are_the_ports_own(name):
    value = getattr(dt, name)
    module = value.__name__ if isinstance(value, types.ModuleType) else value.__module__
    assert module.startswith("darsia_tpu_torch.") and hasattr(da, name)


def _blocked_calls(tmp_path) -> dict:
    """Each NEEDS_LIBRARY entry that imports its library: (the modules to
    block, a call that reaches the import)."""
    def module(name):
        return importlib.import_module(f"darsia_tpu_torch.presets.workflows.{name}")

    seg, thr = module("analysis.analysis_segmentation"), module("analysis.analysis_thresholding")
    helper_result_reader, helper_roi = module("helper.helper_result_reader"), module("helper.helper_roi")
    roi_visualization, utils_media = module("utils.roi_visualization"), module("utils.utils_media")

    image = dt.OpticalImage(torch.rand(6, 8, 3), width=0.8, height=0.6)
    partial = torch.zeros(6, 8, dtype=torch.bool)
    partial[1:4, 2:5] = True
    config = tmp_path / "config.toml"
    mpl = "matplotlib"
    return {
        "utils.utils_media.build_media": ("cv2", lambda: utils_media.build_media(config)),
        "utils.roi_visualization.render_active_region": (
            "cv2",
            lambda: roi_visualization.render_active_region(image, partial),
        ),
        "helper.helper_roi.helper_roi_viewer": (mpl, lambda: helper_roi.helper_roi_viewer(config)),
        "helper.helper_roi.launch_roi_helper_viewer": (
            mpl,
            lambda: helper_roi.launch_roi_helper_viewer([image], mode="mass"),
        ),
        "helper.helper_roi.launch_roi_viewer": (
            mpl,
            lambda: helper_roi.launch_roi_viewer(
                [image], roi_entries={"box": np.array([[0.1, 0.1], [0.5, 0.4]])}, title_prefix="ROI"
            ),
        ),
        "helper.helper_result_reader.launch_result_reader": (
            mpl,
            lambda: helper_result_reader.launch_result_reader([image], mode="mass"),
        ),
        "analysis.analysis_segmentation.analysis_segmentation": (mpl, lambda: seg.analysis_segmentation(config)),
        "analysis.analysis_segmentation.analysis_segmentation_from_context": (
            mpl,
            lambda: seg.analysis_segmentation_from_context(None),
        ),
        "analysis.analysis_thresholding.analysis_thresholding": (mpl, lambda: thr.analysis_thresholding(config)),
        "analysis.analysis_thresholding.analysis_thresholding_from_context": (
            mpl,
            lambda: thr.analysis_thresholding_from_context(None),
        ),
    }


@pytest.mark.parametrize("key", sorted(NEEDS_LIBRARY))
def test_needs_library_entries_name_their_library_where_it_is_absent(key, tmp_path, monkeypatch):
    """``draw_active_region`` draws on a matplotlib axis its caller made (a
    caller without matplotlib has none): it draws on an Agg axis here."""
    if key == "utils.roi_visualization.draw_active_region":
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from darsia_tpu_torch.presets.workflows.utils.roi_visualization import draw_active_region

        fig, ax = plt.subplots()
        full = draw_active_region(ax, torch.rand(6, 8, 3))
        plt.close(fig)
        assert full.mask.all() and len(ax.images) == 1
        return
    library, call = _blocked_calls(tmp_path)[key]
    for name in [n for n in sys.modules if n.split(".")[0] == library] + [library]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match=NEEDS_LIBRARY[key] if library == "matplotlib" else "OpenCV"):
        call()


# ------------------------------------------------ the JAX package -> the port
#
# Every module of ``darsia_tpu`` (but its Pallas kernels and its JAX cache
# set-up) has a counterpart of the same path in ``darsia_tpu_torch``, which
# holds every name of the JAX module's ``__all__`` (or, without one, its
# public module-level definitions), every public method and property of its
# classes, a superset of every public callable's parameter names, and reads
# every ``kwargs``/``options`` key the JAX callable reads, itself or in a
# helper function of the port it calls by name, or takes it as a parameter.

#: What the JAX package has and the port deliberately has not, with why.
JAX_ONLY = {
    "image.image.Image.tree_flatten": "a JAX pytree hook; the port's Image crosses no tracer",
    "image.image.Image.tree_unflatten": "a JAX pytree hook; the port's Image crosses no tracer",
    "parallel.halo.halo_exchange": "JAX axis names (local, axis_name) become shard lists in the port's one-process mesh",
    "parallel.halo.halo_exchange_2d": "JAX axis names (local, row/col_axis_name) become shard lists in the port's one-process mesh",
    "parallel.tpfa.projected_pcg_local": "JAX axis names (axis) become shard lists in the port's one-process mesh",
    "parallel.tpfa.local_tpfa_operator": "JAX axis names (axis, num) become shard lists in the port's one-process mesh",
}

_JAX_ROOT = Path(da.__file__).parent
_READERS = ("kwargs", "options")


def jax_module_paths() -> list:
    """Dotted paths (relative to the package) of the JAX modules compared."""
    paths = []
    for file in sorted(_JAX_ROOT.rglob("*.py")):
        rel = file.relative_to(_JAX_ROOT)
        if rel.parts[:2] == ("ops", "pallas") or rel.as_posix() == "utils/jax_cache.py":
            continue
        parts = list(rel.with_suffix("").parts)
        paths.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return paths


def _module(package, path: str):
    return importlib.import_module(f"{package.__name__}.{path}" if path else package.__name__)


def module_names(module) -> list:
    """``__all__``, else the public module-level definitions of the source."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    tree = ast.parse(Path(module.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _key(fn) -> str:
    """Where a function is defined, relative to its package."""
    fn = inspect.unwrap(fn)
    return f"{fn.__module__.split('.', 1)[1]}.{fn.__qualname__}"


def _callables(module):
    """(key, JAX callable, name, owner) of a module's compared functions
    and methods (owner None for a module function)."""
    for name in module_names(module):
        value = getattr(module, name, None)
        if inspect.isfunction(value) and value.__module__.startswith("darsia_tpu."):
            yield _key(value), value, name, None
        elif inspect.isclass(value) and value.__module__.startswith("darsia_tpu."):
            for member in dir(value):
                if member.startswith("_") and member not in ("__init__", "__call__"):
                    continue
                static = inspect.getattr_static(value, member)
                if isinstance(static, (classmethod, staticmethod)):
                    static = static.__func__
                if isinstance(static, property):
                    fn = static.fget
                elif isinstance(static, types.FunctionType):
                    fn = static
                else:
                    continue
                if fn.__module__.startswith("darsia_tpu."):
                    yield _key(fn), fn, member, value


def keys_read(fn, depth: int = 2) -> set:
    """The constant keys ``fn`` reads from a ``kwargs`` or ``options``
    mapping (``.get``/``.pop``/``.setdefault``, ``[...]``, ``in``), and
    those the functions of its package it calls by name read."""
    fn = inspect.unwrap(fn)
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError):
        return set()
    package = fn.__module__.split(".")[0]
    # A loop or comprehension variable that runs over constant keys
    # (``for k in ("a", "b")``) reads each of them.
    looped = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.For, ast.comprehension))
            and isinstance(node.target, ast.Name)
            and isinstance(node.iter, (ast.Tuple, ast.List, ast.Set))
            and all(isinstance(e, ast.Constant) for e in node.iter.elts)
        ):
            looped.setdefault(node.target.id, set()).update(e.value for e in node.iter.elts)
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in ("get", "pop", "setdefault")
                and isinstance(func.value, ast.Name)
                and func.value.id in _READERS
                and node.args
            ):
                if isinstance(node.args[0], ast.Constant):
                    keys.add(node.args[0].value)
                elif isinstance(node.args[0], ast.Name):
                    keys |= looped.get(node.args[0].id, set())
            elif isinstance(func, ast.Name) and depth > 0:
                helper = getattr(fn, "__globals__", {}).get(func.id)
                if inspect.isfunction(helper) and helper.__module__.split(".")[0] == package:
                    keys |= keys_read(helper, depth - 1)
        elif (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id in _READERS
            and isinstance(node.slice, ast.Constant)
        ):
            keys.add(node.slice.value)
        elif (
            isinstance(node, ast.Compare)
            and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.In, ast.NotIn))
            and isinstance(node.comparators[0], ast.Name)
            and node.comparators[0].id in _READERS
            and isinstance(node.left, ast.Constant)
        ):
            keys.add(node.left.value)
    return keys


def _named_parameters(fn) -> list:
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return []
    return [p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


@functools.lru_cache(maxsize=None)
def audit(group: str) -> dict:
    """The gaps of the port against the JAX modules under ``group`` (the
    first path component; "" for the package itself), by kind."""
    gaps = {"names": [], "members": [], "parameters": [], "keys": []}
    seen = set()
    for path in jax_module_paths():
        if path.split(".")[0] != group and (path or group):
            continue
        jax, port = _module(da, path), _module(dt, path)
        gaps["names"] += [f"{path}.{n}" for n in module_names(jax) if hasattr(jax, n) and not hasattr(port, n)]
        for key, fn, name, owner in _callables(jax):
            if key in seen:
                continue
            seen.add(key)
            port_owner = getattr(port, owner.__name__, None) if owner is not None else port
            if port_owner is None:
                continue  # (a missing class is a missing name)
            if not hasattr(port_owner, name):
                gaps["members"].append(key)
                continue
            if owner is not None and isinstance(inspect.getattr_static(owner, name), property):
                continue
            port_fn = getattr(port_owner, name)
            if owner is not None:
                static = inspect.getattr_static(port_owner, name)
                port_fn = static.__func__ if isinstance(static, (classmethod, staticmethod)) else port_fn
            port_params = _named_parameters(port_fn)
            missing = [p for p in _named_parameters(fn) if p not in port_params]
            if missing:
                gaps["parameters"].append(f"{key}: {missing}")
            unread = sorted(keys_read(fn, depth=0) - keys_read(port_fn) - set(port_params))
            if unread:
                gaps["keys"].append(f"{key}: {unread}")
    return gaps


def _groups() -> list:
    return sorted({path.split(".")[0] for path in jax_module_paths()})


def _without_exceptions(entries: list) -> list:
    return [e for e in entries if e.split(":")[0] not in JAX_ONLY]


def test_every_public_jax_name_is_in_the_port():
    assert not [n for n in public_jax_names() if not hasattr(dt, n)]


def test_every_jax_module_has_a_counterpart():
    paths = jax_module_paths()
    assert len(paths) > 200
    for path in paths:
        _module(dt, path)


@pytest.mark.parametrize("group", _groups())
def test_port_modules_hold_every_name_of_their_jax_module(group):
    assert not audit(group)["names"]


@pytest.mark.parametrize("group", _groups())
def test_port_classes_hold_every_public_method_and_property(group):
    assert not _without_exceptions(audit(group)["members"])


@pytest.mark.parametrize("group", _groups())
def test_port_callables_take_every_jax_parameter_name(group):
    assert not _without_exceptions(audit(group)["parameters"])


@pytest.mark.parametrize("group", _groups())
def test_port_callables_read_every_jax_option_key(group):
    assert not _without_exceptions(audit(group)["keys"])


def test_every_exception_is_still_a_difference():
    found = set()
    for group in _groups():
        gaps = audit(group)
        found |= {e.split(":")[0] for kind in ("members", "parameters", "keys") for e in gaps[kind]}
    assert found == set(JAX_ONLY)


def test_the_audit_finds_a_gap():
    """The audit sees a missing name, member, parameter and key."""
    def jax_fn(a, b, **kwargs):
        return kwargs.get("alpha"), kwargs["beta"], "gamma" in kwargs

    def port_fn(a, beta=None, **kwargs):
        return kwargs.get("alpha")

    assert keys_read(jax_fn) == {"alpha", "beta", "gamma"}
    assert keys_read(jax_fn) - keys_read(port_fn) - set(_named_parameters(port_fn)) == {"gamma"}
    assert [p for p in _named_parameters(jax_fn) if p not in _named_parameters(port_fn)] == ["b"]
