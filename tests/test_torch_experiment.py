"""The experiment protocols and ``ProtocolledExperiment`` against the JAX
package on the CPU.

The JAX package's protocol fixtures (tests/unit/test_experiment_multiphase.py)
and its templates (``presets/workflows/templates``) go through both
packages: the same datetimes, image selections, injected masses and
pressure/temperature states.  The port reads the CSV files without pandas.
"""

import sys
from datetime import datetime, timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import darsia_tpu as da
import darsia_tpu.experiment.protocols as jax_protocols
from darsia_tpu_torch import experiment as te
from darsia_tpu_torch.experiment import protocols as tp

TEMPLATES = Path(jax_protocols.__file__).parents[1] / "presets" / "workflows" / "templates"


def _pt(state):
    """A thermodynamic state's fields (the two packages' classes differ)."""
    return (type(state).__name__, state.pressure, state.temperature)


@pytest.fixture
def protocol_files(tmp_path):
    """The JAX package's fixture: 10 images, one per 30 min, image 3
    blacklisted, one hour of injection at 1e-6 kg/s, two P-T states."""
    start = datetime(2023, 5, 1, 8, 0, 0)
    lines = ["image_id,datetime"]
    for i in range(10):
        lines.append(f"{i},{(start + timedelta(minutes=30 * i)).isoformat()}")
    (tmp_path / "imaging.csv").write_text("\n".join(lines))
    (tmp_path / "blacklist.csv").write_text("image_id\n3")
    end = start + timedelta(hours=1)
    (tmp_path / "injection.csv").write_text(
        "location_x,location_y,start,end,rate_kg_s\n"
        f"0.5,0.5,{start.isoformat()},{end.isoformat()},1e-6"
    )
    (tmp_path / "pt.csv").write_text(
        "datetime,pressure,temperature\n"
        f"{start.isoformat()},1.01,22.0\n"
        f"{(start + timedelta(hours=5)).isoformat()},1.03,24.0"
    )
    paths = []
    for i in range(10):
        p = tmp_path / f"img_{i:05d}.jpg"
        p.write_bytes(b"")
        paths.append(p)
    return tmp_path, paths, start


def test_imaging_protocol_against_jax(protocol_files):
    tmp_path, paths, start = protocol_files
    args = (tmp_path / "imaging.csv",)
    kwargs = {"pad": 5, "blacklist": tmp_path / "blacklist.csv"}
    j, t = da.ImagingProtocol(*args, **kwargs), te.ImagingProtocol(*args, **kwargs)
    assert t.get_datetime(paths[2]) == start + timedelta(minutes=60)
    assert [t.get_datetime(p) for p in paths] == [j.get_datetime(p) for p in paths]
    assert [t.is_blacklisted(p) for p in paths] == [j.is_blacklisted(p) for p in paths]
    assert t.find_images_for_paths(paths) == j.find_images_for_paths(paths)
    assert len(t.find_images_for_paths(paths)) == 9
    targets = [start + timedelta(minutes=m) for m in (0, 44, 91, 500)]
    for tol in (np.inf, 600.0):
        assert t.find_images_for_datetimes(paths, targets, tol) == j.find_images_for_datetimes(
            paths, targets, tol
        )
    assert t.datetime_by_image_id == j.datetime_by_image_id
    assert t.df.columns == list(j.df.columns) and len(t.df) == len(j.df)
    with pytest.raises(ValueError, match="not found"):
        t.get_datetime(tmp_path / "img_00042.jpg")


@pytest.mark.parametrize("when", [-0.5, 0.0, 0.5, 1.0, 3.0])
def test_injection_protocol_against_jax(protocol_files, when):
    tmp_path, _, start = protocol_files
    j = da.InjectionProtocol(tmp_path / "injection.csv")
    t = te.InjectionProtocol(tmp_path / "injection.csv")
    date = start + timedelta(hours=when)
    assert t.injected_mass(date=date) == j.injected_mass(date=date)
    assert t.injected_mass(time=when) == j.injected_mass(time=when)
    roi_in, roi_out = [[0.0, 0.0], [1.0, 1.0]], [[0.6, 0.6], [1.0, 1.0]]
    assert t.injected_mass(date=date, roi=roi_in) == j.injected_mass(date=date, roi=roi_in)
    assert t.injected_mass(date=date, roi=roi_out) == 0.0 == j.injected_mass(date=date, roi=roi_out)
    assert t.num_injections == j.num_injections == 1
    with pytest.raises(ValueError, match="exactly one"):
        t.injected_mass()


@pytest.mark.parametrize("hours", [-1.0, 0.0, 2.5, 5.0, 7.0])
def test_pressure_temperature_protocol_against_jax(protocol_files, hours):
    tmp_path, _, start = protocol_files
    j = da.PressureTemperatureProtocol(tmp_path / "pt.csv")
    t = te.PressureTemperatureProtocol(tmp_path / "pt.csv")
    date = start + timedelta(hours=hours)
    assert _pt(t.get_state(date)) == _pt(j.get_state(date))
    assert 1.01 <= t.get_state(date).pressure <= 1.03
    assert _pt(t.get_gradient(date)) == _pt(j.get_gradient(date))
    assert _pt(t.get_gradient(date, dt_seconds=7.0)) == _pt(j.get_gradient(date, dt_seconds=7.0))


def test_protocolled_experiment_against_jax(protocol_files):
    tmp_path, paths, start = protocol_files
    kwargs = dict(
        data=paths,
        imaging_protocol=tmp_path / "imaging.csv",
        injection_protocol=tmp_path / "injection.csv",
        pressure_temperature_protocol=tmp_path / "pt.csv",
        blacklist_protocol=tmp_path / "blacklist.csv",
    )
    j, t = da.ProtocolledExperiment(**kwargs), te.ProtocolledExperiment(**kwargs)
    assert t.experiment_start == j.experiment_start == start
    assert t.find_images_for_times(1.0) == j.find_images_for_times(1.0) == paths[2]
    times = [0.0, 0.4, 1.5, 1.6, 9.0]
    assert t.find_images_for_times(times) == j.find_images_for_times(times)
    assert t.find_images_for_times(times, tol=600) == j.find_images_for_times(times, tol=600)
    assert t.find_images_for_times(9.0, tol=60) is None is j.find_images_for_times(9.0, tol=60)
    windows = [te.TimeWindow(start=0.0, end=1.0), te.TimeWindow(start=2.5, end=3.2)]
    j_windows = [da.TimeWindow(start=w.start, end=w.end) for w in windows]
    got = t.find_images_for_time_windows(windows)
    assert got == j.find_images_for_time_windows(j_windows)
    assert paths[0] in got and paths[2] in got and paths[3] not in got
    assert t.find_images_for_paths(paths) == j.find_images_for_paths(paths)
    assert t.iter_available(paths) == j.iter_available(paths)
    assert t.time_since_start(start + timedelta(minutes=90)) == 1.5
    # Without an injection protocol the earliest image starts the experiment.
    bare = dict(kwargs, injection_protocol=None)
    assert te.ProtocolledExperiment(**bare).experiment_start == da.ProtocolledExperiment(
        **bare
    ).experiment_start
    with pytest.raises(ValueError, match="No available images"):
        t.find_images_for_times(1.0, data=[tmp_path / "img_00003.jpg"])


def test_init_from_config_and_folder_protocols(protocol_files):
    """``init_from_config`` reads a config's data and protocol sections; an
    imaging protocol per folder picks the protocol by the image's folder."""
    tmp_path, paths, start = protocol_files
    config = SimpleNamespace(
        data=SimpleNamespace(data=paths, pad=5),
        protocol=SimpleNamespace(
            imaging=tmp_path / "imaging.csv",
            injection=tmp_path / "injection.csv",
            pressure_temperature=None,
            blacklist=None,
        ),
    )
    j, t = da.ProtocolledExperiment.init_from_config(config), te.ProtocolledExperiment.init_from_config(config)
    assert t.find_images_for_times([0.5, 2.0]) == j.find_images_for_times([0.5, 2.0])
    assert t.pressure_temperature_protocol is None
    folder = tmp_path / "run"
    folder.mkdir()
    (folder / "img_00001.jpg").write_bytes(b"")
    per_folder = {"data": paths, "imaging_protocol": {tmp_path: tmp_path / "imaging.csv"}}
    t2, j2 = te.ProtocolledExperiment(**per_folder), da.ProtocolledExperiment(**per_folder)
    assert t2.get_datetime(folder / "img_00001.jpg") == j2.get_datetime(folder / "img_00001.jpg")
    assert t2.experiment_start == j2.experiment_start
    with pytest.raises(ValueError, match="No imaging protocol"):
        t2.get_datetime(Path("/elsewhere/img_00001.jpg"))


def test_templates_paths_and_rate_columns_against_jax(tmp_path):
    """The JAX package's templates (space-separated datetimes, ``path``,
    ``rate_kg/s``, ``pressure_bar``/``temperature_celsius``), rates in sccm
    and ml/min, and a path column with an empty cell."""
    imaging = te.ImagingProtocol(TEMPLATES / "imaging_protocol.csv", pad=5)
    j_imaging = da.ImagingProtocol(TEMPLATES / "imaging_protocol.csv", pad=5)
    assert imaging.datetime_by_path_key == j_imaging.datetime_by_path_key
    assert imaging.get_datetime(Path("baseline.JPG")) == datetime(2000, 1, 1)
    for name in ("injection_protocol.csv",):
        date = datetime(2000, 1, 1, 1)
        assert te.InjectionProtocol(TEMPLATES / name).injected_mass(date=date) == da.InjectionProtocol(
            TEMPLATES / name
        ).injected_mass(date=date)
    pt, j_pt = (
        pkg.PressureTemperatureProtocol(TEMPLATES / "pressure_temperature_protocol.csv")
        for pkg in (te, da)
    )
    assert _pt(pt.get_state(datetime(2000, 1, 1))) == _pt(j_pt.get_state(datetime(2000, 1, 1)))
    (tmp_path / "paths.csv").write_text(
        "image_id,datetime,path\n"
        "7,2024-02-03 10:00:00,run\\a\\DSC00007.JPG\n"
        "8,2024-02-03T10:00:30.5,\n"
        "9,2024-02-03 10:01,./DSC00009.JPG\n"
    )
    t, j = (pkg.ImagingProtocol(tmp_path / "paths.csv", pad=5) for pkg in (te, da))
    assert t.datetime_by_path_key == j.datetime_by_path_key
    assert t.datetime_by_image_id == j.datetime_by_image_id
    for name in ("x/a/DSC00007.JPG", "DSC00008.JPG", "DSC00009.JPG"):
        assert t.get_datetime(Path(name)) == j.get_datetime(Path(name))
    start, end = "2024-01-01 00:00:00", "2024-01-01 02:00:00"
    for column, rate in (("rate_sccm", "150"), ("rate_ml/min", "12.5"), ("rate_kg/s", "2e-7")):
        path = tmp_path / f"injection_{column.replace('/', '_')}.csv"
        path.write_text(f"location_x,location_y,start,end,{column}\n0.1,0.2,{start},{end},{rate}\n")
        for hours in (0.5, 4.0):
            assert te.InjectionProtocol(path).injected_mass(time=hours) == da.InjectionProtocol(
                path
            ).injected_mass(time=hours)
    bad = tmp_path / "bad.csv"
    bad.write_text("location_x,location_y,start,end,rate\n0,0,2024-01-01,2024-01-02,1\n")
    with pytest.raises(ValueError, match="rate_kg_s"):
        te.InjectionProtocol(bad)


def test_formats_and_legacy_protocol(tmp_path, monkeypatch):
    """Excel protocols name pandas' Excel reader where it does not import;
    an unknown suffix and a non-ISO datetime raise; the legacy interval
    protocol's JSON reads both ways."""
    monkeypatch.setitem(sys.modules, "openpyxl", None)
    with pytest.raises(ImportError, match="openpyxl"):
        te.InjectionProtocol(tmp_path / "injection.xlsx")
    with pytest.raises(ValueError, match="Unsupported"):
        te.InjectionProtocol(tmp_path / "injection.txt")
    with pytest.raises(ValueError, match="Sheet name"):
        te.ImagingProtocol((tmp_path / "imaging.csv", "Sheet1"), pad=5)
    (tmp_path / "us.csv").write_text("image_id,datetime\n1,05/01/2023 08:00\n")
    with pytest.raises(ValueError, match="ISO 8601"):
        te.ImagingProtocol(tmp_path / "us.csv", pad=5)
    intervals = [
        tp.ImagingInterval(0, 9, datetime(2023, 5, 1, 8), 30.0),
        tp.ImagingInterval(10, 19, datetime(2023, 5, 1, 9), 60.0),
    ]
    legacy = te.ImagingProtocolOld(intervals, pad=5)
    legacy.save(tmp_path / "legacy.json")
    j_legacy = da.ImagingProtocolOld.load(tmp_path / "legacy.json")
    for i in (0, 9, 12, 25):
        name = Path(f"img_{i:05d}.jpg")
        assert legacy.get_datetime(name) == j_legacy.get_datetime(name)
    j_legacy.save(tmp_path / "legacy_jax.json")
    assert te.ImagingProtocolOld.load(tmp_path / "legacy_jax.json").intervals == intervals


def test_find_images_for_datetimes_against_jax(protocol_files):
    from darsia_tpu.experiment.events import find_images_for_datetimes as jax_find

    tmp_path, paths, start = protocol_files
    protocol = te.ImagingProtocol(tmp_path / "imaging.csv", pad=5)
    targets = [start + timedelta(minutes=m) for m in (10, 100, 1000)]
    got = te.find_images_for_datetimes(tmp_path, protocol, targets)
    assert got == jax_find(tmp_path, da.ImagingProtocol(tmp_path / "imaging.csv", pad=5), targets)
    assert got[0] == paths[0] and got[2] == paths[9]
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="No protocolled images"):
        te.find_images_for_datetimes(empty, protocol, targets)
