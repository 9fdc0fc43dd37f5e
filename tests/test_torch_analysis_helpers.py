"""The analysis steps' helpers against pandas and the JAX package.

``utils/csv_table.py`` writes, byte for byte, what ``DataFrame.to_csv(index=
False)`` writes for the workflow tables (datetime columns at every
precision, missing values, integer columns), and a second run (the file
read back, rows appended, sorted by time) as the JAX loops do it with
pandas, cell for cell but for the last bit of a float that pandas' parser
reads back inexactly.  The progress events, the PNG previews (OpenCV here; without it
``ImportError`` naming it) and the image export formats (npy, npz
and csv with a resolution and a dtype; jpg without matplotlib raises naming
it) against the JAX package's on the same inputs.
"""

import logging
import sys
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.presets.workflows.analysis import progress as jax_progress
from darsia_tpu.presets.workflows.analysis import streaming as jax_streaming
from darsia_tpu.presets.workflows.analysis.image_export_formats import ImageExportFormats as JaxFormats
from darsia_tpu.presets.workflows.config.format_registry import ImageExportFormat as JaxFormat
from darsia_tpu_torch.presets.workflows.analysis import progress, streaming
from darsia_tpu_torch.presets.workflows.analysis.image_export_formats import ImageExportFormats
from darsia_tpu_torch.presets.workflows.config.format_registry import ImageExportFormat
from darsia_tpu_torch.utils.csv_table import CsvTable

torch.set_num_threads(1)

START = datetime(2026, 8, 1, 12, 0, 0)

#: Rows of a workflow table: (time, datetime) per row, the rest made alike.
DATES = {
    "seconds": [START, START + timedelta(hours=1), START + timedelta(minutes=30)],
    "milliseconds": [START, START + timedelta(seconds=1.5), START + timedelta(hours=2)],
    "microseconds": [START, START + timedelta(microseconds=7), START + timedelta(hours=2)],
    "midnights": [datetime(2026, 8, 1), datetime(2026, 8, 3), datetime(2026, 8, 2)],
    "missing": [None, START, START + timedelta(hours=3)],
}


def _rows(dates, times=None):
    times = times or [3600.0 * k for k in range(len(dates))]
    return [
        {
            "time": t,
            "datetime": d,
            "image_stem": f"img_{k:03d}",
            "mass": 0.1 * k + 1e-7,
            "count": k,
        }
        for k, (t, d) in enumerate(zip(times, dates))
    ]


def _pandas_loop(rows, frame=None):
    import warnings

    frame = pd.DataFrame() if frame is None else frame
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for row in rows:
            frame = pd.concat([frame, pd.DataFrame([row])], ignore_index=True)
            frame.sort_values(by="time", inplace=True)
    return frame


def _table_loop(rows, table=None):
    table = table or CsvTable()
    for row in rows:
        table.append(row)
        table.sort_by("time")
    return table


def _written(table: CsvTable, path) -> str:
    table.write(path)
    return path.read_text()


@pytest.mark.parametrize("kind", sorted(DATES))
def test_first_run_is_written_as_pandas_writes_it(tmp_path, kind):
    rows = _rows(DATES[kind])
    want = _pandas_loop(rows).to_csv(index=False)
    assert _written(_table_loop(rows), tmp_path / "t.csv") == want


@pytest.mark.parametrize(
    "times", [[None, 3600.0, 1800.0], [7200.0, None, None]], ids=["one missing", "two missing"]
)
def test_missing_times_sort_last_as_pandas_sorts_them(tmp_path, times):
    rows = _rows(DATES["seconds"], times)
    want = _pandas_loop(rows).to_csv(index=False)
    table = _table_loop(rows)
    assert _written(table, tmp_path / "t.csv") == want
    assert [r["image_stem"] for r in table.records()] == list(_pandas_loop(rows)["image_stem"])


@pytest.mark.parametrize("kind", ["seconds", "milliseconds", "missing"])
def test_second_run_reads_back_appends_and_sorts_as_pandas(tmp_path, kind):
    first = _rows(DATES[kind])
    second = _rows([START + timedelta(minutes=10), START + timedelta(hours=5)], [600.0, 18000.0])
    second[1]["extra"] = 2.5  # a column only the second run has
    path = tmp_path / "t.csv"
    _table_loop(first).write(path)
    want = _pandas_loop(second, pd.read_csv(path)).to_csv(index=False).splitlines()
    table = _table_loop(second, CsvTable.read(path))
    got = _written(table, tmp_path / "again.csv").splitlines()
    assert len(table.records()) == 5 and got[0] == want[0]
    # Cell for cell; a float read back may differ in its last bit, since
    # pandas' C parser does not round-trip every repr (the port reads with
    # Python's float(), exactly).
    for row_got, row_want in zip(got[1:], want[1:]):
        for a, b in zip(row_got.split(","), row_want.split(",")):
            if a == b:
                continue
            assert float(a) == pytest.approx(float(b), rel=4.5e-16, abs=0), (a, b)


def test_read_infers_types_as_read_csv(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c,d,e\n1,1.5,x,True,\n2,,y,False,\n")
    table = CsvTable.read(path)
    frame = pd.read_csv(path)
    assert table.columns == list(frame.columns)
    assert [r["a"] for r in table.rows] == [1, 2]
    assert [r["b"] for r in table.rows] == [1.5, None]
    assert [r["d"] for r in table.rows] == [True, False]
    assert [r["e"] for r in table.rows] == [None, None]
    assert _written(table, tmp_path / "again.csv") == frame.to_csv(index=False)


PAYLOADS = [
    {"event": "image_progress", "step": " mass ", "image_index": -3, "image_total": 8, "image_path": "a.npz"},
    {"event": "step_complete", "step": "volume", "step_elapsed_s": float("nan")},
    {"event": "step_start", "step": "", "image_total": 4},
    {"event": "bogus", "step": "mass"},
    {"event": "image_progress", "step": "mass", "image_index": 1.5, "image_duration_s": -2.0},
    ["not", "a", "dict"],
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_progress_events_normalize_as_the_jax_package(payload):
    assert progress.normalize_progress_event(payload) == jax_progress.normalize_progress_event(payload)


def test_progress_publishers_send_the_jax_payloads():
    got, want = [], []
    for module, out in ((progress, got), (jax_progress, want)):
        module.publish_step_start(out.append, step="mass", image_total=-1)
        module.publish_image_progress(
            out.append, step="mass", image_path="p", image_index=2, image_total=8,
            image_duration_s=0.25, step_elapsed_s=float("inf"),
        )
        module.publish_step_complete(out.append, step="mass", image_total=8, step_elapsed_s=3)
        module.publish_step_start(lambda payload: 1 / 0, step="mass", image_total=1)  # swallowed
    assert got == want and len(got) == 3


def test_png_preview_is_the_jax_package_png():
    rgb = (np.random.default_rng(1).random((500, 900, 3))).astype(np.float32)
    image = dt.OpticalImage(torch.from_numpy(rgb), width=1.8, height=1.0)
    assert streaming.encode_low_resolution_png(image) == jax_streaming.encode_low_resolution_png(rgb)
    sent = []
    streaming.publish_stream_images(sent.append, {"a": image, "skip": None})
    assert list(sent[0]) == ["a"] and sent[0]["a"][:4] == b"\x89PNG"


def test_png_preview_without_opencv_names_it(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        streaming.encode_low_resolution_png(np.zeros((4, 4, 3), np.uint8))
    sent = []
    with caplog.at_level(logging.WARNING):
        streaming.publish_stream_images(
            sent.append, {"a": np.zeros((4, 4, 3))}, logger=logging.getLogger("t"), error_message="preview failed"
        )
    assert sent == [] and "preview failed" in caplog.text


SPECS = [
    {"type": "npy", "identifier": "npy"},
    {"type": "npy", "identifier": "small", "resolution": (20, 30), "dtype": "float16"},
    {"type": "npz", "identifier": "npz", "resolution": (25, 25), "keep_ratio": True},
    {"type": "csv", "identifier": "csv", "name": "stem_hhmm", "float_format": "{:.4e}"},
]


@pytest.mark.parametrize("spec", SPECS, ids=[s["identifier"] for s in SPECS])
def test_export_formats_write_the_jax_files(tmp_path, spec):
    data = np.random.default_rng(2).random((40, 64)).astype(np.float32)
    meta = {"width": 1.6, "height": 1.0, "time": 5400.0}
    port = ImageExportFormats([ImageExportFormat(**spec)]).export(
        dt.ScalarImage(torch.from_numpy(data), **meta), tmp_path / "port", "img_001"
    )
    jax = JaxFormats([JaxFormat(**spec)]).export(da.ScalarImage(data, **meta), tmp_path / "jax", "img_001")
    assert [p.relative_to(tmp_path / "port") for p in port] == [p.relative_to(tmp_path / "jax") for p in jax]
    (got,), (want,) = port, jax
    if spec["type"] == "npy":
        a, b = np.load(got), np.load(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() <= 1e-6
    elif spec["type"] == "npz":
        a, b = dt.imread(got, device="cpu"), da.imread(want)
        assert a.img.shape == b.img.shape and np.abs(a.img.numpy() - np.asarray(b.img)).max() <= 1e-6
        assert a.time == b.time
    else:
        assert got.read_text() == want.read_text()


def test_jpg_export_without_matplotlib_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    exporter = ImageExportFormats.from_analysis_config(None, None)
    assert [s.type for s in exporter.formats] == ["npz", "jpg"]
    with pytest.raises(ImportError, match="matplotlib"):
        exporter.export(dt.ScalarImage(torch.zeros((4, 5)), width=1.0, height=1.0), tmp_path, "x")
