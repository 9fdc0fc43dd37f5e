"""The port keeps the JAX package's public names.

Every public name of ``darsia_tpu`` that some module of ``darsia_tpu_torch``
defines is reachable as ``darsia_tpu_torch.<name>``, and is the port's own
object.  The names of the parts that cannot be ported to the card's machine
(ROADMAP Queue 1, "Not portable": decoders, plots, VTK, EMD through OpenCV,
Excel) are the only exception.  Also the two signatures that ROADMAP Queue 3
fault P1 names: ``interpolate_measurements_2d`` takes JAX's two arguments
(the device defaults to the card), and
``load_curvature_correction_config_from_toml`` warns on a file without a
``[curvature]`` section as JAX's does.
"""

import __future__
import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

#: ROADMAP Queue 1, "Not portable on the card's machine".
NOT_PORTABLE = {
    "imread_from_bytes",  # JPEG/PNG decode
    "imread_from_optical",
    "imread_from_dicom",  # DICOM
    "imread_from_vtu",  # VTU
    "plotting",  # show*, plots, to_vtk
    "augmented_plotting",
    "plot_contour_on_image",
    "plot_distribution_on_image",
    "plot_image_statistics",
    "to_vtk",
    "EMD",  # cv2.emd
}


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
            # (A type alias such as ColorCheckerPosition = str is builtin.)
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
        "PorosityAnalysis",
        "patched_porosity_analysis",
        "KernelInterpolation",
        "GaussianKernel",
        "Masks",
        "validate_mode_syntax",
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
