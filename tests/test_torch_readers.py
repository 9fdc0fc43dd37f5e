"""The gated readers: DICOM (pydicom), VTU (meshio) and Excel tables
(pandas' ``read_excel``), against the JAX package.

pydicom, meshio and openpyxl are not installed here: stand-in modules put
into ``sys.modules`` serve the same seeded data to both packages (pydicom's
``dcmread`` and ``pixel_data_handlers.util.apply_modality_lut``, meshio's
``read``), and ``pandas.read_excel`` is patched to return seeded frames as
pandas would (a dict of every sheet for ``sheet_name=None``).  Both
packages must read equal arrays (exactly: DICOM values are integers; the
port keeps a VTU's float64 grid, which cast to float32 equals the JAX
package's), equal dimensions and equal tables.  Without the library, the
port's reader raises ``ImportError`` naming it.

The JAX package passes ``sheet_name=None`` to ``read_excel`` for a protocol
without a sheet name, which gives a dict of sheets that it cannot index
(ROADMAP Queue 3, reference fault 31); the port reads the first sheet.
"""

import sys
import types
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.experiment import protocols as jax_protocols
from darsia_tpu.presets.workflows.facies_props import FaciesProps as JaxFaciesProps
from darsia_tpu_torch.experiment import protocols as port_protocols
from darsia_tpu_torch.presets.workflows.facies_props import FaciesProps

torch.set_num_threads(1)


def _np(image):
    x = image.img if hasattr(image, "img") else image
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ DICOM


def _dicom_slices(seed=0, located=True):
    rng = np.random.default_rng(seed)
    slices = {}
    for k, location in enumerate([2.0, -1.0, 0.5, 4.0]):
        ds = SimpleNamespace(
            pixel_array=rng.integers(0, 4000, (6, 9)).astype(np.uint16),
            RescaleSlope=2.0,
            RescaleIntercept=-1024.0,
            InstanceNumber=10 - k,
            PixelSpacing=[0.5, 0.25],
            SliceThickness=1.5,
        )
        if located:
            ds.SliceLocation = location
        slices[f"slice{k}.dcm"] = ds
    return slices


@pytest.fixture
def pydicom_stub(monkeypatch):
    served = {}
    pydicom = types.ModuleType("pydicom")
    handlers = types.ModuleType("pydicom.pixel_data_handlers")
    util = types.ModuleType("pydicom.pixel_data_handlers.util")
    pydicom.dcmread = lambda path: served[Path(path).name]
    util.apply_modality_lut = lambda arr, ds: arr * ds.RescaleSlope + ds.RescaleIntercept
    pydicom.pixel_data_handlers, handlers.util = handlers, util
    for name, module in (("pydicom", pydicom), ("pydicom.pixel_data_handlers", handlers), ("pydicom.pixel_data_handlers.util", util)):
        monkeypatch.setitem(sys.modules, name, module)
    return served


@pytest.mark.parametrize("located", [True, False], ids=["SliceLocation", "InstanceNumber"])
def test_dicom_stack_matches_jax(tmp_path, pydicom_stub, located):
    pydicom_stub.update(_dicom_slices(located=located))
    paths = []
    for name in pydicom_stub:
        (tmp_path / name).write_bytes(b"DICM")
        paths.append(tmp_path / name)
    jax_image = da.imread(paths)
    port_image = dt.imread(paths, device="cpu")
    assert isinstance(port_image, dt.ScalarImage) and port_image.space_dim == 3
    assert port_image.img.device.type == "cpu" and port_image.shape == (4, 6, 9)
    np.testing.assert_array_equal(_np(port_image), _np(jax_image))
    assert port_image.dimensions == pytest.approx(jax_image.dimensions, abs=0) == [6.0, 3.0, 2.25]
    single = dt.imread_from_dicom(paths[0], device="cpu")
    np.testing.assert_array_equal(_np(single), _np(da.imread_from_dicom(paths[0])))


def test_dicom_without_pydicom_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pydicom", None)
    (tmp_path / "a.dcm").write_bytes(b"DICM")
    with pytest.raises(ImportError, match="pydicom"):
        dt.imread(tmp_path / "a.dcm", device="cpu")
    with pytest.raises(ImportError, match="pydicom"):
        dt.imread_from_dicom(tmp_path / "a.dcm", device="cpu")


# -------------------------------------------------------------------- VTU


def _mesh(seed):
    """A triangulated 9 x 7 point lattice over [0, 2] x [0, 1] with point
    data ``data`` and cell data ``cells``."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0.0, 2.0, 9), np.linspace(0.0, 1.0, 7))
    points = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1)
    triangles = []
    for j in range(6):
        for i in range(8):
            a, b, c, d = j * 9 + i, j * 9 + i + 1, (j + 1) * 9 + i, (j + 1) * 9 + i + 1
            triangles += [[a, b, c], [b, d, c]]
    triangles = np.asarray(triangles)
    return SimpleNamespace(
        points=points,
        point_data={"data": np.round(rng.random((len(points), 1)) * 100)},
        cells=[SimpleNamespace(data=triangles)],
        cell_data={"cells": [np.round(rng.random(len(triangles)) * 100)]},
    )


@pytest.fixture
def meshio_stub(monkeypatch):
    served = {}
    meshio = types.ModuleType("meshio")
    meshio.read = lambda path: served[Path(path).name]
    monkeypatch.setitem(sys.modules, "meshio", meshio)
    return served


@pytest.mark.parametrize("key,shape", [("data", None), ("cells", (30, 50))])
def test_vtu_matches_jax(tmp_path, meshio_stub, key, shape):
    meshio_stub.update({f"m{k}.vtu": _mesh(k) for k in range(2)})
    paths = [tmp_path / f"m{k}.vtu" for k in range(2)]
    for p in paths:
        p.write_bytes(b"<VTKFile/>")
    kwargs = {"key": key} if shape is None else {"key": key, "shape": shape}
    jax_image = da.imread(paths[0], **kwargs)
    port_image = dt.imread(paths[0], device="cpu", **kwargs)
    # The resampled float64 grid; the JAX package holds it as float32.
    assert port_image.img.dtype == torch.float64
    np.testing.assert_array_equal(_np(port_image).astype(np.float32), _np(jax_image))
    assert port_image.shape == (shape or (200, 200))
    assert port_image.dimensions == jax_image.dimensions == [1.0, 2.0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_series = da.imread_from_vtu(paths, **kwargs)
        port_series = dt.imread_from_vtu(paths, device="cpu", **kwargs)
    assert port_series.series and port_series.time_num == 2
    np.testing.assert_array_equal(_np(port_series).astype(np.float32), _np(jax_series))


def test_vtu_missing_key_and_missing_meshio(tmp_path, meshio_stub, monkeypatch):
    meshio_stub["m.vtu"] = _mesh(0)
    (tmp_path / "m.vtu").write_bytes(b"<VTKFile/>")
    for pkg, extra in ((da, {}), (dt, {"device": "cpu"})):
        with pytest.raises(KeyError, match="nothing"):
            pkg.imread(tmp_path / "m.vtu", key="nothing", **extra)
    monkeypatch.setitem(sys.modules, "meshio", None)
    with pytest.raises(ImportError, match="meshio"):
        dt.imread(tmp_path / "m.vtu", device="cpu")


# ------------------------------------------------------------------ Excel


SHEETS = {
    "imaging.xlsx": pd.DataFrame(
        {
            "image_id": [1, 2, 3, 5],
            "datetime": pd.to_datetime(
                ["2024-03-01 08:00:00", "2024-03-01 08:10:00", "2024-03-01 08:20:30", "2024-03-01 09:00:00"]
            ),
            "path": ["run/img_00001.jpg", None, "run/img_00003.jpg", "run/img_00005.jpg"],
        }
    ),
    "blacklist.xlsx": pd.DataFrame({"image_id": [3]}),
    "injection.xlsx": pd.DataFrame(
        {
            "location_x": [0.5, 1.5],
            "location_y": [0.2, 0.3],
            "start": pd.to_datetime(["2024-03-01 08:00", "2024-03-01 09:00"]),
            "end": pd.to_datetime(["2024-03-01 08:30", "2024-03-01 10:00"]),
            "rate_ml/min": [2.0, 3.5],
        }
    ),
    "pressure.xls": pd.DataFrame(
        {
            "datetime": pd.to_datetime(["2024-03-01 09:00", "2024-03-01 08:00", "2024-03-01 10:00"]),
            "pressure_bar": [1.02, 1.01, 1.03],
            "temperature_celsius": [21.0, 20.5, 22.0],
        }
    ),
    "facies.xlsx": pd.DataFrame({"id": [0, 1, 2], "porosity": [0.44, 0.38, 0.2], "permeability": [2e-10, 5e-11, 1e-12]}),
}


@pytest.fixture
def excel(monkeypatch, tmp_path):
    """Sheets served by a patched ``pandas.read_excel``; the engines are
    stand-ins."""
    calls = []

    def read_excel(path, sheet_name=0, **kwargs):
        calls.append(sheet_name)
        frame = SHEETS[Path(path).name]
        if sheet_name is None:
            return {"Sheet1": frame.copy()}
        if sheet_name not in (0, "Sheet1"):
            raise ValueError(f"Worksheet named '{sheet_name}' not found")
        return frame.copy()

    monkeypatch.setattr(pd, "read_excel", read_excel)
    for engine in ("openpyxl", "xlrd"):
        monkeypatch.setitem(sys.modules, engine, types.ModuleType(engine))
    for name in SHEETS:
        (tmp_path / name).write_bytes(b"PK")
    return calls


def test_excel_protocols_match_jax(tmp_path, excel):
    imaging = (tmp_path / "imaging.xlsx", "Sheet1")
    blacklist = (tmp_path / "blacklist.xlsx", "Sheet1")
    jax_imaging = jax_protocols.ImagingProtocol(imaging, pad=5, blacklist=blacklist)
    port_imaging = port_protocols.ImagingProtocol(imaging, pad=5, blacklist=blacklist)
    assert port_imaging.datetime_by_image_id == jax_imaging.datetime_by_image_id
    assert port_imaging.datetime_by_path_key == jax_imaging.datetime_by_path_key
    assert port_imaging.blacklist_ids == jax_imaging.blacklist_ids == {3}
    files = [Path("run") / f"img_{k:05d}.jpg" for k in range(1, 7)]
    assert port_imaging.find_images_for_paths(files) == jax_imaging.find_images_for_paths(files)
    targets = ["2024-03-01 08:05:00", "2024-03-01 08:58:00"]
    assert port_imaging.find_images_for_datetimes(files, targets) == jax_imaging.find_images_for_datetimes(files, targets)

    injection = (tmp_path / "injection.xlsx", "Sheet1")
    jax_injection = jax_protocols.InjectionProtocol(injection)
    port_injection = port_protocols.InjectionProtocol(injection)
    for hours in (0.1, 0.5, 2.0):
        assert port_injection.injected_mass(time=hours) == jax_injection.injected_mass(time=hours)
    moment = pd.Timestamp("2024-03-01 09:30").to_pydatetime()
    assert port_injection.injected_mass(date=moment) == jax_injection.injected_mass(date=moment)

    pressure = (tmp_path / "pressure.xls", 0)
    jax_pt = jax_protocols.PressureTemperatureProtocol(pressure)
    port_pt = port_protocols.PressureTemperatureProtocol(pressure)
    for when in ("2024-03-01 08:30", "2024-03-01 09:45"):
        moment = pd.Timestamp(when).to_pydatetime()
        for got, want in ((port_pt.get_state(moment), jax_pt.get_state(moment)), (port_pt.get_gradient(moment), jax_pt.get_gradient(moment))):
            assert (got.pressure, got.temperature) == (want.pressure, want.temperature)
    assert "Sheet1" in excel and 0 in excel


def test_excel_protocol_without_a_sheet_reads_the_first(tmp_path, excel):
    """Reference fault 31: the JAX package asks pandas for every sheet and
    gets a dict of frames."""
    with pytest.raises(AttributeError, match="columns"):
        jax_protocols.InjectionProtocol(tmp_path / "injection.xlsx")
    port = port_protocols.InjectionProtocol(tmp_path / "injection.xlsx")
    named = port_protocols.InjectionProtocol((tmp_path / "injection.xlsx", "Sheet1"))
    assert port.injected_mass(time=1.0) == named.injected_mass(time=1.0) > 0
    assert excel[-2:] == [0, "Sheet1"]


def test_excel_facies_props_match_jax(tmp_path, excel):
    labels = np.repeat(np.arange(3), 8).reshape(4, 6)
    jax_props = JaxFaciesProps.load(da.Image(labels, scalar=True), tmp_path / "facies.xlsx")
    port_props = FaciesProps.load(dt.Image(torch.from_numpy(labels), scalar=True), tmp_path / "facies.xlsx")
    for key in ("porosity", "permeability"):
        np.testing.assert_allclose(_np(getattr(port_props, key)), _np(getattr(jax_props, key)), rtol=1e-7)
    assert _np(port_props.porosity)[0, 0] == np.float32(0.44)


def test_excel_facies_in_setup_matches_jax(tmp_path, excel):
    from test_torch_rig import _np as rig_np
    from test_torch_rig import _write_assets, _write_config

    from darsia_tpu.presets.workflows import setup as jax_setup
    from darsia_tpu_torch.presets.workflows import setup

    _write_assets(tmp_path)
    configs = {}
    for name in ("jax", "port"):
        path = _write_config(tmp_path, name, "full")
        text = path.read_text().replace("facies.csv", "facies.xlsx")
        path.write_text(text + "\n[facies.facies_to_labels]\n0 = [0]\n1 = [1, 2]\n")
        configs[name] = path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_setup.segment_colored_image(configs["jax"])
        setup.segment_colored_image(configs["port"], device="cpu")
        j = jax_setup.setup_facies(configs["jax"])
        t = setup.setup_facies(configs["port"], device="cpu")
    np.testing.assert_array_equal(rig_np(t), rig_np(j))


def test_excel_without_pandas_or_its_reader_names_them(tmp_path, excel, monkeypatch):
    monkeypatch.setitem(sys.modules, "openpyxl", None)
    with pytest.raises(ImportError, match="openpyxl"):
        port_protocols.InjectionProtocol(tmp_path / "injection.xlsx")
    monkeypatch.setitem(sys.modules, "xlrd", None)
    with pytest.raises(ImportError, match="xlrd"):
        port_protocols.PressureTemperatureProtocol(tmp_path / "pressure.xls")
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        FaciesProps.load(dt.Image(torch.zeros(2, 2, dtype=torch.int64), scalar=True), tmp_path / "facies.xlsx")
