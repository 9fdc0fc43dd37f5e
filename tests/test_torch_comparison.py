"""The comparison workflow's compute and assemble steps against the JAX
package on the CPU.

The JAX package's comparison test (tests/unit/test_comparison_wasserstein.py)
through both packages: the same mass maps in, the same pairs, result files,
metadata and CSV out, the distances within 1e-5 relative.  The result JSON
files and the assembled CSV read both ways; the real mass loader
(``_load_mass`` through ``load_data``) on a folder of npz maps found by a CSV
imaging protocol.
"""

import importlib
import shutil
from dataclasses import asdict, dataclass, field
from datetime import datetime, timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

# The packages re-export the entry function under the module's name, so
# resolve the modules themselves.
cw = importlib.import_module("darsia_tpu.presets.workflows.comparison.comparison_wasserstein")
tw = importlib.import_module(
    "darsia_tpu_torch.presets.workflows.comparison.comparison_wasserstein"
)
PARITY = 1e-5
META = {"width": 1.0, "height": 1.0, "scalar": True}


def _mass(seed, n=10):
    """The JAX test's map: a block plus noise, unit physical mass, float32."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((n, n))
    arr[2:5, 2:5] = 1.0
    arr += 0.05 * rng.random((n, n))
    arr /= arr.sum() * 0.01
    return arr.astype(np.float32)


@dataclass
class _WConfig:
    results: Path = None
    runs: list = field(default_factory=lambda: ["run_a", "run_b", "run_c"])
    resize_factor: float = None
    relative_tol: float = 0.5
    times: list = field(default_factory=lambda: [(1.0, 0.1), (2.0, 0.1)])


@dataclass
class _Config:
    wasserstein: _WConfig = None
    runs: object = None


def _fake_loader(arrays, image):
    masses = {key: image(arr) for key, arr in arrays.items()}

    def load(run_name, config, time, tol, resize_factor, device=None):
        return masses.get((str(run_name), float(time)))

    return load


def _port_image(arr):
    return dt.Image(torch.from_numpy(arr), **META)


def _jax_image(arr):
    return da.Image(arr, **META)


def _run_both(tmp_path, monkeypatch, arrays, **wconfig):
    """``_compute`` of both packages on the same maps: (jax, port) results
    and their result folders."""
    out = {}
    for name, module, image in (("jax", cw, _jax_image), ("port", tw, _port_image)):
        monkeypatch.setattr(module, "_load_mass", _fake_loader(arrays, image))
        folder = tmp_path / name
        config = _Config(wasserstein=_WConfig(results=folder, **wconfig))
        out[name] = (module._compute(None, config, skip_existing=False), config)
    return out


def _six_maps():
    keys = [(run, time) for time in (1.0, 2.0) for run in ("run_a", "run_b", "run_c")]
    return {key: _mass(seed) for seed, key in enumerate(keys, start=1)}


def test_compute_and_assemble_against_jax(tmp_path, monkeypatch):
    arrays = _six_maps()
    out = _run_both(tmp_path, monkeypatch, arrays)
    (jax_results, jax_config), (port_results, port_config) = out["jax"], out["port"]
    assert len(port_results) == len(jax_results) == 6  # 3 pairs at 2 times
    for t, j in zip(port_results, jax_results):
        assert (t.run_a, t.run_b, t.time, t.roi) == (j.run_a, j.run_b, j.time, j.roi)
        assert abs(t.distance - j.distance) <= PARITY * j.distance
        assert t.metadata == j.metadata  # float64 totals summed alike
        assert t.get_result_filename() == j.get_result_filename()
        assert (port_config.wasserstein.results / t.get_result_filename()).exists()
        # The batch against the per-pair facade (the JAX test's bound).
        alone = dt.wasserstein_distance(
            _port_image(arrays[(t.run_a, t.time)]), _port_image(arrays[(t.run_b, t.time)]),
            method="newton",
        )
        assert t.distance == pytest.approx(alone, rel=2e-3)
    rows = tw._assemble(port_config)
    frame = cw._assemble(jax_config)
    assert rows == [asdict(r) for r in sorted(port_results, key=lambda r: r.get_result_filename())]
    t_lines = (port_config.wasserstein.results / "wasserstein_distances.csv").read_text().splitlines()
    j_lines = (jax_config.wasserstein.results / "wasserstein_distances.csv").read_text().splitlines()
    assert len(t_lines) == len(j_lines) == len(frame) + 1 == 7
    assert t_lines[0] == j_lines[0] == "run_a,run_b,time,distance,roi,metadata"
    for t_line, j_line in zip(t_lines[1:], j_lines[1:]):
        t_head, t_dist, t_tail = t_line.split(",", 3)[:3], t_line.split(",")[3], t_line.split(",", 4)[4]
        j_head, j_dist, j_tail = j_line.split(",", 3)[:3], j_line.split(",")[3], j_line.split(",", 4)[4]
        assert t_head == j_head and t_tail == j_tail
        assert abs(float(t_dist) - float(j_dist)) <= PARITY * float(j_dist)


def test_result_files_and_csv_read_both_ways(tmp_path):
    """A result written by either package loads in the other; the port's
    ``_assemble`` of the JAX package's files writes the JAX package's CSV,
    byte for byte (names with spaces and commas, an ROI, NaN, metadata)."""
    results = [
        ("run a", "run,b", 1.5, 0.123456789012345, None, {"total_a": 1.0, "total_b": 0.9999999}),
        ("r1", "r2", 10.0, float("nan"), "box", {}),
        ("r1", "r3", 0.25, 1e-05, None, {"note": 'say "hi"'}),
    ]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for args in results:
        cw.WassersteinDistanceResult(*args).save_to_dir(jax_dir)
        tw.WassersteinDistanceResult(*args).save_to_dir(port_dir)
    for name in sorted(p.name for p in jax_dir.glob("*.json")):
        assert (jax_dir / name).read_text() == (port_dir / name).read_text()
        from_jax = tw.WassersteinDistanceResult.load(jax_dir / name)
        from_port = cw.WassersteinDistanceResult.load(port_dir / name)
        assert repr(asdict(from_jax)) == repr(asdict(from_port))
    both = tmp_path / "both"
    shutil.copytree(jax_dir, both)
    config = _Config(wasserstein=_WConfig(results=jax_dir))
    cw._assemble(config)
    rows = tw._assemble(_Config(wasserstein=_WConfig(results=both)))
    assert len(rows) == 3
    want = (jax_dir / "wasserstein_distances.csv").read_text()
    assert (both / "wasserstein_distances.csv").read_text() == want
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tw._assemble(_Config(wasserstein=_WConfig(results=empty))) == []
    assert (empty / "wasserstein_distances.csv").read_text() == "\n"  # pandas' empty frame


def test_skips_mismatched_masses_and_existing_results(tmp_path, monkeypatch):
    """A mass mismatch above ``relative_tol`` is skipped (the JAX test);
    ``skip_existing`` skips pairs whose file exists; a lone pair of its grid
    takes ``wasserstein_distance``, as in the JAX package."""
    big = _mass(1)
    arrays = {("run_a", 1.0): big, ("run_b", 1.0): big * 0.1}
    out = _run_both(tmp_path, monkeypatch, arrays, runs=["run_a", "run_b"], times=[(1.0, 0.1)],
                    relative_tol=0.2)
    assert out["port"][0] == [] == out["jax"][0]
    arrays = {("run_a", 1.0): _mass(1), ("run_b", 1.0): _mass(2)}
    out = _run_both(tmp_path, monkeypatch, arrays, runs=["run_a", "run_b"], times=[(1.0, 0.1)])
    (port,), (jax,) = out["port"][0], out["jax"][0]
    assert abs(port.distance - jax.distance) <= PARITY * jax.distance
    again = tw._compute(None, out["port"][1], skip_existing=True)
    assert again == []


def _run_folder(root, run, seeds, start, n=12):
    """A run's folder as the analysis exports it: npz mass maps saved with
    ``Image.save`` (ids 0, 1, 2, one per hour), a CSV imaging protocol."""
    folder = root / run
    (folder / "mass" / "npz").mkdir(parents=True)
    lines = ["image_id,datetime"]
    for i, seed in enumerate(seeds):
        dt.Image(torch.from_numpy(_mass(seed, n)), **META).save(
            folder / "mass" / "npz" / f"mass_{i:05d}.npz"
        )
        lines.append(f"{i},{(start + timedelta(hours=i)).isoformat(sep=' ')}")
    (folder / "imaging.csv").write_text("\n".join(lines) + "\n")
    (folder / "injection.csv").write_text(
        f"location_x,location_y,start,end,rate_kg_s\n0.5,0.5,{start.isoformat()},"
        f"{(start + timedelta(hours=1)).isoformat()},1e-6\n"
    )
    return SimpleNamespace(
        analysis=SimpleNamespace(mass=SimpleNamespace(folder=folder)),
        data=SimpleNamespace(data=[], pad=5),
        protocol=SimpleNamespace(imaging=folder / "imaging.csv", injection=folder / "injection.csv",
                                 pressure_temperature=None, blacklist=None),
    )


def test_load_mass_through_load_data_against_jax(tmp_path):
    """The real ``_load_mass``: ``load_data`` finds the npz map closest to the
    time through the run's experiment and reads it (``device="cpu"``), with
    ``Resize`` for a ``resize_factor``; then ``_compute`` on those maps."""
    start = datetime(2024, 3, 1, 9)
    config = _Config(runs=SimpleNamespace(config={
        "run_a": _run_folder(tmp_path, "run_a", (1, 2, 3), start),
        "run_b": _run_folder(tmp_path, "run_b", (4, 5, 6), start),
    }))
    for time, tol in ((0.0, None), (1.2, 0.5), (2.0, 0.1)):
        got = tw._load_mass("run_a", config, time, tol, None, device="cpu")
        want = cw._load_mass("run_a", config, time, tol, None)
        assert got.img.device.type == "cpu"
        assert np.array_equal(got.img.numpy(), np.asarray(want.img))
    assert tw._load_mass("run_a", config, 1.5, 0.1, None, device="cpu") is None
    assert cw._load_mass("run_a", config, 1.5, 0.1, None) is None
    small = tw._load_mass("run_b", config, 1.0, None, 0.5, device="cpu")
    small_jax = cw._load_mass("run_b", config, 1.0, None, 0.5)
    assert small.img.shape == (6, 6)
    assert np.abs(small.img.numpy() - np.asarray(small_jax.img)).max() <= 1e-6
    with pytest.raises(ValueError, match="not recognized"):
        tw.load_data(config.runs.config["run_a"], "concentration", 1.0)
    config.wasserstein = _WConfig(results=tmp_path / "port", runs=["run_a", "run_b"],
                                  times=[(0.0, 0.1), (1.0, 0.1), (2.0, 0.1)])
    port = tw._compute(None, config, skip_existing=False, device="cpu")
    config.wasserstein.results = tmp_path / "jax"
    jax = cw._compute(None, config, skip_existing=False)
    assert len(port) == len(jax) == 3
    for t, j in zip(port, jax):
        assert t.time == j.time and t.metadata == j.metadata
        assert abs(t.distance - j.distance) <= PARITY * j.distance


def test_config_entry_raises_naming_the_config_layer():
    with pytest.raises(NotImplementedError, match="presets/workflows/config"):
        tw.comparison_wasserstein(None, "config.toml", compute=True)
    package = importlib.import_module("darsia_tpu_torch.presets.workflows.comparison")
    assert package.comparison_wasserstein is tw.comparison_wasserstein
    assert package.WassersteinDistanceResult is tw.WassersteinDistanceResult
