"""The port's host prefetch loader and the thread-safety of the reading path.

The cases of ``tests/unit/test_prefetch.py`` on ``darsia_tpu_torch.utils.
prefetch``; ``Rig.read_images`` (order, and a frame that cannot be read
skipped); a loaded rig read from 4 threads at once (each read equal to the
sequential read, bitwise, and the curvature correction's pull-back grid
built exactly once); the kernel build run once when threads ask together.
"""

import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import darsia_tpu_torch as dt
from darsia_tpu_torch.corrections.shape.curvature import CurvatureCorrection
from darsia_tpu_torch.ops import warp2pass
from darsia_tpu_torch.presets.workflows import setup as rig_setup
from darsia_tpu_torch.presets.workflows.analysis.analysis_context import iter_prefetched_images
from darsia_tpu_torch.utils import tracing
from darsia_tpu_torch.utils.prefetch import PrefetchResult, default_workers, prefetch_map

torch.set_num_threads(1)

RH, RW, PHOTOS = 48, 64, 6


class TestPrefetchMap:
    def test_order_and_values(self):
        out = list(prefetch_map(lambda x: x * 2, [3, 1, 2], depth=2))
        assert [r.item for r in out] == [3, 1, 2]
        assert [r.value for r in out] == [6, 2, 4]
        assert all(isinstance(r, PrefetchResult) and r.ok for r in out)

    def test_error_isolation(self):
        def fn(x):
            if x == "bad":
                raise RuntimeError("corrupt frame")
            return x.upper()

        out = list(prefetch_map(fn, ["a", "bad", "b"], depth=2))
        assert [r.ok for r in out] == [True, False, True]
        assert out[1].item == "bad" and isinstance(out[1].error, RuntimeError)
        assert out[2].value == "B"

    def test_overlap(self):
        """Loads overlap: 6 x 50 ms on 3 workers << sequential."""

        def slow(x):
            time.sleep(0.05)
            return x

        t0 = time.perf_counter()
        out = list(prefetch_map(slow, range(6), depth=3, workers=3))
        assert [r.value for r in out] == list(range(6))
        assert time.perf_counter() - t0 < 0.25  # sequential would be 0.30+

    def test_sequential_fallback(self):
        seen = set()

        def fn(x):
            seen.add(threading.get_ident())
            return x

        out = list(prefetch_map(fn, [1, 2, 3], depth=0))
        assert [r.value for r in out] == [1, 2, 3]
        assert seen == {threading.get_ident()}

    def test_single_item(self):
        out = list(prefetch_map(lambda x: x, [42], depth=4))
        assert len(out) == 1 and out[0].value == 42

    def test_defaults(self):
        import os

        assert default_workers() == max(1, min(8, os.cpu_count() or 1))


def test_iter_prefetched_images_yields_none_on_failure(tmp_path):
    class Reader:
        def read_image(self, path):
            if "bad" in str(path):
                raise IOError("unreadable")
            return f"img:{path.name}"

    class Ctx:
        fluidflower = Reader()
        image_paths = [tmp_path / "a.npz", tmp_path / "bad.npz", tmp_path / "b.npz"]

    rows = list(iter_prefetched_images(Ctx()))
    assert [index for index, _, _ in rows] == [1, 2, 3]
    assert rows[0][2] == "img:a.npz" and rows[1][2] is None and rows[2][2] == "img:b.npz"


@pytest.fixture(scope="module")
def rig_folder(tmp_path_factory):
    """A rig with a curvature correction set up on the CPU from a TOML
    config, saved; its photographs drifted by a column each."""
    tmp = tmp_path_factory.mktemp("prefetch_rig")
    (tmp / "images").mkdir()
    rng = np.random.default_rng(3)
    base = (rng.uniform(0.1, 0.9, (RH, RW, 3)) * 255).astype(np.uint8)
    for i in range(PHOTOS):
        dt.OpticalImage(torch.from_numpy(np.roll(base, i, axis=1)), width=1.0, height=0.8).save(
            tmp / "images" / f"img_{i:05d}.npz"
        )
    sketch = np.zeros((RH, RW, 3), np.float32)
    sketch[RH // 2 :] = 1.0
    dt.OpticalImage(torch.from_numpy(sketch), width=1.0, height=0.8).save(tmp / "sketch.npz")
    (tmp / "depth.csv").write_text("x,y,mean\n0,0,0.02\n1,0,0.02\n0,0.8,0.03\n1,0.8,0.02\n0.5,0.4,0.025\n")
    (tmp / "imaging.csv").write_text(
        "image_id,datetime\n" + "".join(f"{i},2024-03-01 {9 + i:02d}:00:00\n" for i in range(PHOTOS))
    )
    (tmp / "config.toml").write_text(
        f"""
[data]
folder = "{tmp / 'images'}"
baseline = "img_00000.npz"
results = "{tmp / 'results'}"
[rig]
width = 1.0
height = 0.8
dim = 2
resolution = [{RH}, {RW}]
[depth]
measurements = "{tmp / 'depth.csv'}"
[labeling]
colored_image = "{tmp / 'sketch.npz'}"
[protocols]
imaging = "{tmp / 'imaging.csv'}"
[corrections.curvature.config.bulge]
horizontal_bulge = 1e-5
vertical_bulge = 2e-5
"""
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rig_setup.setup_depth_map(tmp / "config.toml", device="cpu")
        rig_setup.segment_colored_image(tmp / "config.toml", device="cpu")
        rig = rig_setup.setup_rig(dt.Rig, tmp / "config.toml", device="cpu")
    photos = sorted((tmp / "images").glob("*.npz"))
    return tmp / "results" / "setup" / "rig", rig.experiment, photos


def _loaded(rig_folder):
    folder, experiment, _ = rig_folder
    rig = dt.Rig.load(folder, device="cpu")
    rig.load_experiment(experiment)
    return rig


def test_read_images_in_order_and_skipping(rig_folder):
    _, _, photos = rig_folder
    rig = _loaded(rig_folder)
    paths = [photos[2], photos[0], photos[0].with_name("missing.npz"), photos[1]]
    read = list(rig.read_images(paths, depth=3))
    assert [p.name for p, _ in read] == [photos[2].name, photos[0].name, photos[1].name]
    for path, image in read:
        assert torch.equal(image.img, rig.read_image(path).img)
    sequential = list(rig.read_images(paths, depth=0))
    assert [p for p, _ in sequential] == [p for p, _ in read]


def test_threads_build_the_curvature_grid_once(rig_folder, monkeypatch):
    """4 threads read through a freshly loaded rig at once: the curvature
    correction's grid is built once (the spy sleeps inside the build to
    widen the race), and every read equals the sequential read."""
    _, _, photos = rig_folder
    builds = []
    original = CurvatureCorrection._precompute_transformed_coordinates

    def spy(self, shape, device):
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return original(self, shape, device)

    monkeypatch.setattr(CurvatureCorrection, "_precompute_transformed_coordinates", spy)
    rig = _loaded(rig_folder)
    assert any(isinstance(c, CurvatureCorrection) for c in rig.corrections)
    barrier = threading.Barrier(4)
    got = {}

    def read(path):
        barrier.wait()
        return rig.read_image(path)

    threads = [threading.Thread(target=lambda p=p: got.__setitem__(p, read(p))) for p in photos[:4]]
    _run(threads)
    assert len(builds) == 1 and len(got) == 4
    prefetched = dict(rig.read_images(photos, depth=4))
    assert len(builds) == 1
    reference = _loaded(rig_folder)
    for path in photos:
        want = reference.read_image(path).img
        assert torch.equal(prefetched[path].img, want)
        if path in got:
            assert torch.equal(got[path].img, want)


def test_kernel_build_runs_once_across_threads(monkeypatch):
    """Threads that launch first together wait for one build."""
    calls = []

    def fake_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return {"darsia_warp_rows_t": object()}

    monkeypatch.setattr(warp2pass, "_entries", None)
    monkeypatch.setattr(warp2pass, "_build_and_bind", fake_build)
    barrier = threading.Barrier(4)
    results = []

    def build():
        barrier.wait()
        results.append(warp2pass.build_kernel())

    _run([threading.Thread(target=build) for _ in range(4)])
    assert len(calls) == 1
    assert all(r is results[0] for r in results)


def test_launch_counters_lose_no_increment(monkeypatch):
    """Counted launches from 16 threads, switching as often as the
    interpreter allows: every increment arrives (the launch itself replaced
    by a stub, so the count alone is exercised)."""
    monkeypatch.setattr(warp2pass, "_takes_plain", lambda *a, **k: False)
    monkeypatch.setattr(warp2pass, "_launch", lambda *a, **k: None)
    data = torch.zeros((1, 4, 8))
    cols = torch.zeros((4, 8))
    per_thread = 300

    def launch():
        for _ in range(per_thread):
            warp2pass.warp_rows_t(data, cols, 1)
            warp2pass.warp_rows(data[0], cols, 1)

    before = (tracing.counter("k1.launches"), tracing.counter("k2.launches"))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run([threading.Thread(target=launch) for _ in range(16)])
    finally:
        sys.setswitchinterval(interval)
    after = (tracing.counter("k1.launches"), tracing.counter("k2.launches"))
    assert after[0] - before[0] == after[1] - before[1] == 16 * per_thread


def _run(threads, timeout: float = 60.0) -> None:
    """Start the threads, join each within ``timeout``, and check that all
    finished."""
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
