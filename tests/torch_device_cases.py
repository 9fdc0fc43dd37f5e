"""The device-parity sweep: one table of cases over the port's public surface.

Every public class and function of ``darsia_tpu_torch`` (``public_names()``,
enumerated as ``tests/test_torch_api_surface.py`` enumerates the package) is
either exercised by a case of ``CASES`` or listed in ``EXEMPT`` with its
category.  A case is a builder ``fn(device, seed)`` that makes its inputs
with ``numpy.random.default_rng(seed)`` at a small size and returns its
outputs as a tree of tensors, numpy arrays, numbers, strings and images.
``device`` is a torch device, or None for the entry point's default call:
numpy input and no ``device=``, which goes to the CUDA card (and raises
without one) unless the case runs on the host (``where="host"``, where the
JAX counterpart is host code too; ``cite`` names the JAX line).

The same case runs on ``cpu`` and on ``cuda:0`` (``run_case``), and
``compare`` holds the two within the case's tolerance: ``|card - cpu| <=
atol + rtol * |cpu|`` element-wise, or, for a case that warps through
``warp_backend`` (K1's two passes on the card, the gather warp on the CPU),
the two-pass tier that ``chip_smoke.py`` gates (``bench.py:1133``: mean <
2e-3, p99.9 < 0.05, max < 0.45, relative to the data's scale).  A case whose
library does not import (``needs``) expects the ``ImportError`` naming it.

This module imports neither JAX nor ``darsia_tpu``: the CPU tests
(``tests/test_torch_device_cases_<layer>.py``), the card's tests
(``tests/test_torch_gpu_device_cases.py``) and ``chip_smoke.py``'s phase R
all import it.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import io
import math
import sys
import tempfile
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import darsia_tpu_torch as dt  # noqa: E402

LAYERS = ("image", "corrections", "restoration", "signals", "analysis", "presets", "utils")
# bench.py:1133: the two-pass warp against the exact gather warp, on 0-1 data.
WARP_TIER = {"mean": 2e-3, "p999": 0.05, "max": 0.45}


def public_names() -> list:
    """The public classes and functions of ``darsia_tpu_torch``."""
    return sorted(
        name
        for name in dir(dt)
        if not name.startswith("_")
        and (inspect.isclass(getattr(dt, name)) or inspect.isfunction(getattr(dt, name)))
    )


@dataclass(frozen=True)
class Case:
    name: str
    names: tuple
    layer: str
    fn: Callable
    rtol: float
    atol: float
    where: str = "card"
    cite: str = ""
    default: bool = True
    warp: bool = False
    k1: int = 0
    needs: str = ""


CASES: dict = {}


def case(*names, layer, rtol=1e-5, atol=1e-6, where="card", cite="", default=True, warp=False, k1=0, needs=""):
    """Register the decorated builder as a case exercising ``names``.

    Args:
        rtol, atol: the CPU-vs-card tolerance (not used by a warp case).
        where: "card", or "host" where the JAX counterpart is host code
            (``cite`` names the JAX file and line that shows it).
        default: ``fn(None, seed)`` makes the entry point's default call
            (numpy input, no ``device=``).
        warp: the case warps through ``warp_backend``: compared at the
            two-pass tier, its K1 calls held bitwise to the plain K1.
        k1: its K1 launches on the card.
        needs: an optional library; where it does not import, the case
            expects the ImportError naming it.

    """
    if layer not in LAYERS or where not in ("card", "host") or (where == "host") != bool(cite):
        raise ValueError(f"case {names}: layer {layer!r}, where {where!r}, cite {cite!r}")

    def register(fn):
        if fn.__name__ in CASES:
            raise ValueError(f"two cases named {fn.__name__}")
        CASES[fn.__name__] = Case(
            fn.__name__, tuple(names), layer, fn, rtol, atol, where, cite, default, warp, k1, needs
        )
        return fn

    return register


# ---------------------------------------------------------------- helpers


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def on(x, dev):
    """numpy ``x`` as given (the default call) or as a tensor on ``dev``."""
    if dev is None:
        return x
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def kw(dev) -> dict:
    """``device=dev`` unless this is the default call."""
    return {} if dev is None else {"device": dev}


def scalar(arr, dev, **meta):
    return dt.ScalarImage(arr, **kw(dev), **meta)


def optical(arr, dev, **meta):
    return dt.OpticalImage(arr, **kw(dev), **meta)


def smooth(rng, shape, channels=None, lo=0.1, hi=0.9, noise=0.05) -> np.ndarray:
    """A smooth float32 field in [lo, hi] (channels last when given), with
    ``noise`` (standard deviation) on top."""
    rows, cols = shape
    y = np.linspace(0, 1, rows)[:, None]
    x = np.linspace(0, 1, cols)[None, :]
    layers = []
    for _ in range(channels or 1):
        a, b, c = rng.uniform(1, 3, 3)
        f = 0.5 + 0.25 * np.sin(a * np.pi * x + c) * np.cos(b * np.pi * y) + noise * rng.standard_normal((rows, cols))
        layers.append(lo + (hi - lo) * np.clip(f, 0, 1))
    out = np.stack(layers, axis=-1) if channels else layers[0]
    return out.astype(np.float32)


@contextlib.contextmanager
def scratch():
    """A temporary folder, removed after the case."""
    with tempfile.TemporaryDirectory(prefix="darsia_device_case_") as folder:
        yield Path(folder)


@contextlib.contextmanager
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with contextlib.redirect_stdout(io.StringIO()):
            yield


def has_module(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


# ---------------------------------------------------------------- running


def run_case(c: Case, device, seed: int = 0):
    """``c.fn(device, seed)`` with a fixed torch seed and quiet output."""
    torch.manual_seed(seed)
    with quiet():
        return c.fn(None if device is None else torch.device(device), seed)


def expects_import_error(c: Case) -> bool:
    return bool(c.needs) and not has_module(c.needs)


def leaves(tree, path="out"):
    """(path, leaf) pairs of an output tree."""
    if isinstance(tree, dict):
        for key in tree:
            yield from leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, np.ndarray):
        for k, item in enumerate(tree):
            yield from leaves(item, f"{path}[{k}]")
    else:
        yield path, tree


def as_array(leaf):
    """A leaf as a float64 (or object: strings) numpy array."""
    if isinstance(leaf, dt.Image):
        leaf = leaf.img
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bool:
            leaf = leaf.to(torch.uint8)
        return leaf.to(torch.float64).numpy()
    if isinstance(leaf, (str, bytes, type(None))):
        return np.asarray(leaf, dtype=object)
    arr = np.asarray(leaf)
    if arr.dtype.kind in "biuf":
        return arr.astype(np.float64)
    return arr


def devices_of(tree) -> list:
    """(path, device) of every tensor and image in the tree."""
    found = []
    for path, leaf in leaves(tree):
        if isinstance(leaf, dt.Image):
            found.append((path, leaf.img.device if isinstance(leaf.img, torch.Tensor) else "numpy"))
        elif isinstance(leaf, torch.Tensor):
            found.append((path, leaf.device))
    return found


def off_card(tree) -> list:
    """Paths of tensors and images of the tree that are not on ``cuda:0``."""
    return [
        f"{path} on {dev}"
        for path, dev in devices_of(tree)
        if not (isinstance(dev, torch.device) and dev.type == "cuda" and dev.index in (None, 0))
    ]


def finite(tree) -> list:
    """Paths of numeric leaves with a non-finite value."""
    bad = []
    for path, leaf in leaves(tree):
        arr = as_array(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(path)
    return bad


def compare(c: Case, ref, out) -> tuple:
    """(worst ratio of difference to tolerance, faults) of ``out`` against
    ``ref``: element-wise ``atol + rtol * |ref|``, or for a warp case the
    two-pass tier on the gate's inner crop (every axis longer than 16 loses
    8 voxels at each end, where the two passes meet the border), each
    statistic over its bound.  Non-finite values must sit alike."""
    worst, faults = 0.0, []
    a_leaves, b_leaves = list(leaves(ref)), list(leaves(out))
    if [p for p, _ in a_leaves] != [p for p, _ in b_leaves]:
        return math.inf, [f"tree {[p for p, _ in a_leaves]} != {[p for p, _ in b_leaves]}"]
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        x, y = as_array(a), as_array(b)
        if x.shape != y.shape:
            faults.append(f"{path}: shape {x.shape} != {y.shape}")
            worst = math.inf
            continue
        if x.dtype.kind != "f" or y.dtype.kind != "f":
            if not np.array_equal(x, y):
                faults.append(f"{path}: {x!r} != {y!r}"[:300])
                worst = math.inf
            continue
        finite = np.isfinite(x)
        if not (np.array_equal(finite, np.isfinite(y)) and np.array_equal(x[~finite], y[~finite], equal_nan=True)):
            faults.append(f"{path}: non-finite values differ")
            worst = math.inf
            continue
        if c.warp:
            inner = tuple(slice(8, -8) if n > 16 else slice(None) for n in x.shape)
            d = np.abs(x - y)[inner][finite[inner]] / max(1.0, float(np.abs(x[finite]).max(initial=0.0)))
            if d.size == 0:
                continue
            stats = {"mean": float(d.mean()), "p999": float(np.quantile(d, 0.999)), "max": float(d.max())}
            ratio = max(stats[k] / WARP_TIER[k] for k in WARP_TIER)
        else:
            ratio = float((np.abs(x - y) / (c.atol + c.rtol * np.abs(x)))[finite].max(initial=0.0))
        worst = max(worst, ratio)
        if ratio > 1.0:
            diff = float(np.abs(x - y)[finite].max())
            faults.append(f"{path}: max |diff| {diff:.3g} is {ratio:.3g}x the tolerance")
    return worst, faults


def identical(ref, out) -> list:
    """Paths where two runs' outputs differ at all (NaNs alike count as equal)."""
    a_leaves, b_leaves = list(leaves(ref)), list(leaves(out))
    if [p for p, _ in a_leaves] != [p for p, _ in b_leaves]:
        return ["the output trees differ"]
    bad = []
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        x, y = as_array(a), as_array(b)
        same = x.shape == y.shape and (
            np.array_equal(x, y, equal_nan=True) if x.dtype.kind == "f" else np.array_equal(x, y)
        )
        if not same:
            bad.append(path)
    return bad


def k1_held(w2p, fn) -> tuple:
    """(``fn()``, its K1 calls, the faults): each K1 call's inputs and output
    are copied at the wrapper, and after ``fn`` the plain K1 runs on the
    copies and is held bitwise to the kernel's output."""
    calls, wrapper = [], w2p.warp_rows_t

    def record(data, cols, max_disp, impl="auto"):
        out = wrapper(data, cols, max_disp, impl)
        calls.append((data.clone(), cols.clone(), max_disp, out.clone()))
        return out

    w2p.warp_rows_t = record
    try:
        result = fn()
    finally:
        w2p.warp_rows_t = wrapper
    faults = []
    for k, (data, cols, max_disp, out) in enumerate(calls):
        plain = w2p.warp_rows_t_reference(data, cols, max_disp)
        if not torch.equal(out, plain):
            faults.append(f"K1 call {k} {tuple(data.shape)} D={max_disp}: max |diff| to the plain K1 "
                          f"{float((out - plain).abs().max())}")
    return result, calls, faults


def card_parity(c: Case, w2p, seed: int = 0, device="cuda:0") -> dict:
    """One case on the CPU and on the card: the worst ratio of difference to
    tolerance, the K1 launches on the card (counted from 0), the calls held
    bitwise to the plain K1, the faults and the seconds.  A case whose
    library does not import must raise the ImportError naming it on both."""
    tic = time.perf_counter()
    if expects_import_error(c):
        faults = []
        for dev in ("cpu", device):
            try:
                run_case(c, dev, seed)
                faults.append(f"{dev}: no ImportError naming {c.needs}")
            except ImportError as err:
                if c.needs not in str(err):
                    faults.append(f"{dev}: ImportError not naming {c.needs}: {err}")
        return {"worst": 0.0, "launches": 0, "held": 0, "faults": faults, "s": time.perf_counter() - tic,
                "import_error": True}
    ref = run_case(c, "cpu", seed)
    w2p.launch_count = 0
    out, calls, faults = k1_held(w2p, lambda: run_case(c, device, seed))
    torch.cuda.synchronize()
    launches = w2p.launch_count
    worst, diffs = compare(c, ref, out)
    faults = faults + diffs
    if c.where == "card":
        faults += [f"not on the card: {where}" for where in off_card(out)]
    if launches != c.k1 or len(calls) != launches:
        faults.append(f"{launches} K1 launches ({len(calls)} recorded), the table says {c.k1}")
    return {"worst": worst, "launches": launches, "held": len(calls), "faults": faults,
            "s": time.perf_counter() - tic, "import_error": False}


# ================================================================ image core


@case("Image", "ScalarImage", "OpticalImage", layer="image")
def image_classes(dev, seed):
    rng = rng_of(seed)
    rgb = smooth(rng, (48, 64), 3)
    img = optical(rgb, dev, width=1.6, height=1.2)
    gray = img.to_monochromatic("gray")
    hsv = img.to_trichromatic("HSV", return_image=True)
    sub = img.subregion((slice(4, 40), slice(8, 56)))
    roi = img.subregion(dt.make_coordinate([[0.2, 0.3], [1.2, 1.0]]))
    arithmetic = dt.ScalarImage(gray.img * 2.0 + 1.0, **gray.metadata())
    series = dt.ScalarImage(on(np.stack([smooth(rng, (48, 64)) for _ in range(3)], -1), dev),
                            series=True, time=[0.0, 1.0, 2.0], **kw(dev))
    series.append(dt.ScalarImage(series.img[..., :1], series=True, time=[3.0]))
    grid = img.add_grid(dx=0.4, dy=0.4, color=(1.0, 0.0, 0.0))
    point = gray.eval(dt.make_coordinate([0.5, 0.5]))
    img.img = rgb * 0.5  # the setter: numpy onto the image's device
    return {"gray": gray, "hsv": hsv, "sub": sub, "roi": roi, "arith": arithmetic,
            "series": series.time_interval(slice(1, 4)), "slice": series.time_slice(2), "grid": grid,
            "point": point, "set": img, "integral": gray.integral(), "copy": gray.copy().astype(torch.float64)}


@case("ExtensiveImage", layer="image")
def extensive_image(dev, seed):
    rng = rng_of(seed)
    img = dt.ExtensiveImage(smooth(rng, (40, 56)), width=1.4, height=1.0, **kw(dev))
    img.resize(0.5)
    return {"img": img, "integral": img.integral()}


@case("CoordinateSystem", "check_equal_coordinatesystems", "voxels_to_coordinates", "coordinates_to_voxels",
      layer="image", default=False)
def coordinate_system(dev, seed):
    rng = rng_of(seed)
    a = dt.ScalarImage(torch.zeros((40, 56), device=dev), width=1.4, height=1.0)
    b = dt.ScalarImage(torch.zeros((40, 56), device=dev), width=1.4, height=1.0, origin=[0.1, 1.0])
    cs = a.coordinatesystem
    voxels = rng.integers(0, 40, (20, 2))
    coords = cs.coordinate(dt.make_voxel(voxels))
    origin = torch.tensor([0.0, 1.0], dtype=torch.float64, device=dev)
    size = torch.tensor([0.025, 0.025], dtype=torch.float64, device=dev)
    vox = torch.as_tensor(voxels, dtype=torch.float64, device=dev)
    back = dt.voxels_to_coordinates(vox, origin, size)
    return {
        "coords": coords, "voxels": cs.voxel(coords), "length": cs.length(10, "x"),
        "equal": list(dt.check_equal_coordinatesystems(a.coordinatesystem, b.coordinatesystem)),
        "to_coords": back, "to_voxels": dt.coordinates_to_voxels(back, origin, size),
        "continuous": dt.coordinates_to_voxels(back + 0.003, origin, size, continuous=True),
    }


@case("CoordinateTransformation", layer="image", default=False)
def coordinate_transformation(dev, seed):
    rng = rng_of(seed)
    src = dt.ScalarImage(torch.as_tensor((rng.random((40, 56)) * 255).astype(np.uint8), device=dev),
                         width=1.4, height=1.0)
    dst = dt.ScalarImage(torch.zeros((48, 60), device=dev), width=1.5, height=1.2, origin=[0.2, 1.3])
    pts = np.array([[0.3, 0.2], [1.2, 0.25], [1.1, 0.9], [0.4, 0.8]])
    ct = dt.CoordinateTransformation(src.coordinatesystem, dst.coordinatesystem,
                                     dt.make_coordinate(pts), dt.make_coordinate(pts * 0.98 + [0.15, 0.1]))
    out = ct(src)
    return {"img": out, "box": str(ct.find_intersection()), "meta": ct.correct_metadata(src)["dimensions"]}


@case("ROI", layer="image")
def roi_class(dev, seed):
    rng = rng_of(seed)
    img = scalar(smooth(rng, (40, 56)), dev, width=1.4, height=1.0)
    roi = dt.ROI(dt.make_coordinate([[0.2, 0.1], [1.0, 0.8]]))
    return {"cut": roi(img), "mask": roi.mask(img), "in": roi.contains(dt.make_coordinate([0.5, 0.5]))}


@case("Patches", layer="image")
def patches(dev, seed):
    rng = rng_of(seed)
    img = optical(smooth(rng, (48, 64), 3), dev, width=1.6, height=1.2)
    p = dt.Patches(img, [3, 4], rel_overlap=0.1)
    return {"patch": p(1, 2), "assembled": p.assemble(), "blended": p.blend_and_assemble(),
            "position": p.position(1, 2)}


@case("stack", "superpose", "weight", "zeros_like", "ones_like", layer="image")
def arithmetics(dev, seed):
    rng = rng_of(seed)
    a = scalar(smooth(rng, (40, 56)), dev, width=1.4, height=1.0)
    b = scalar(smooth(rng, (40, 56)), dev, width=1.4, height=1.0, origin=[0.7, 1.0])
    w = scalar(smooth(rng, (20, 28)), dev, width=1.4, height=1.0)
    return {"stack": dt.stack([a, a]), "superpose": dt.superpose([a, b]), "weight": dt.weight(a, w),
            "weight_f": dt.weight(a, 2.5), "zeros": dt.zeros_like(a), "ones": dt.ones_like(a, dtype=torch.float64)}


@case("imread", "imread_from_numpy", "imread_from_npz", layer="image")
def imread_arrays(dev, seed):
    rng = rng_of(seed)
    arr = smooth(rng, (40, 56))
    with scratch() as folder:
        np.save(folder / "a.npy", arr)
        dt.ScalarImage(torch.from_numpy(arr), width=1.4, height=1.0).save(folder / "b.npz")
        out = {"npy": dt.imread(folder / "a.npy", **kw(dev), width=1.4, height=1.0),
               "numpy": dt.imread_from_numpy(folder / "a.npy", **kw(dev)),
               "npz": dt.imread_from_npz(folder / "b.npz", **kw(dev)),
               "list": dt.imread([folder / "a.npy", folder / "a.npy"], **kw(dev), series=True, time=[0, 1])}
    return out


@case("imread_from_optical", "imread_from_bytes", layer="image", needs="cv2")
def imread_photographs(dev, seed):
    cv2 = importlib.import_module("cv2")
    rng = rng_of(seed)
    u8 = (smooth(rng, (48, 64), 3) * 255).astype(np.uint8)
    with scratch() as folder:
        cv2.imwrite(str(folder / "a.png"), u8)
        ok, buf = cv2.imencode(".png", u8)
        out = {"png": dt.imread_from_optical(folder / "a.png", **kw(dev), width=1.6, height=1.2),
               "jpg_path": dt.imread(folder / "a.png", **kw(dev)),
               "bytes": dt.imread_from_bytes(bytes(buf.tobytes()), **kw(dev))}
    return out


@case("imread_from_dicom", layer="image", needs="pydicom")
def imread_dicom(dev, seed):
    rng = rng_of(seed)
    data = (rng.random((16, 20)) * 1000).astype(np.uint16)
    with scratch() as folder:
        if not has_module("pydicom"):  # the reader raises naming pydicom
            (folder / "a.dcm").write_bytes(data.tobytes())
            return {"dcm": dt.imread_from_dicom(folder / "a.dcm", **kw(dev))}
        from pydicom.dataset import FileDataset, FileMetaDataset
        from pydicom.uid import ExplicitVRLittleEndian

        meta = FileMetaDataset()
        meta.TransferSyntaxUID = ExplicitVRLittleEndian
        ds = FileDataset(str(folder / "a.dcm"), {}, file_meta=meta, preamble=b"\0" * 128)
        ds.Rows, ds.Columns = data.shape
        ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
        ds.SamplesPerPixel, ds.PixelRepresentation = 1, 0
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.PixelSpacing = [0.5, 0.5]
        ds.SliceThickness = 1.0
        ds.PixelData = data.tobytes()
        ds.save_as(str(folder / "a.dcm"), enforce_file_format=True)
        return {"dcm": dt.imread_from_dicom(folder / "a.dcm", **kw(dev))}


@case("imread_from_vtu", layer="image", needs="meshio")
def imread_vtu(dev, seed):
    rng = rng_of(seed)
    if not has_module("meshio"):  # the reader raises naming meshio
        with scratch() as folder:
            (folder / "a.vtu").write_text("<VTKFile/>")
            return {"vtu": dt.imread_from_vtu(folder / "a.vtu", **kw(dev))}
    meshio = importlib.import_module("meshio")
    n = 6
    xs, ys = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1))
    points = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], 1)
    cells = [[j * (n + 1) + i, j * (n + 1) + i + 1, (j + 1) * (n + 1) + i + 1, (j + 1) * (n + 1) + i]
             for j in range(n) for i in range(n)]
    with scratch() as folder:
        meshio.write(folder / "a.vtu", meshio.Mesh(points, [("quad", np.array(cells))],
                                                  cell_data={"data": [rng.random(len(cells))]}))
        return {"vtu": dt.imread_from_vtu(folder / "a.vtu", key="data", **kw(dev), width=1.0, height=1.0,
                                          dim=2, vtu_dim=2, shape=(12, 12))}


@case("cartesianToMatrixIndexing", "matrixToCartesianIndexing", "interpret_indexing", "to_cartesian_indexing",
      "to_matrix_indexing", layer="image", where="host", cite="darsia_tpu/image/indexing.py:103-125 (numpy)")
def indexing(dev, seed):
    arr = rng_of(seed).random((5, 6, 3))
    return {"m2c": dt.matrixToCartesianIndexing(arr), "c2m": dt.cartesianToMatrixIndexing(arr[..., 0]),
            "interpret": list(dt.interpret_indexing("x", "ij")), "cart": dt.to_cartesian_indexing("i", "ij"),
            "matrix": dt.to_matrix_indexing("y", "xy")}


@case("Coordinate", "CoordinateArray", "Voxel", "VoxelArray", "VoxelCenter", "VoxelCenterArray", "make_coordinate",
      "make_voxel", "make_voxel_center", "to_coordinate", "to_voxel", "to_voxel_center", layer="image",
      where="host", cite="darsia_tpu/utils/point.py:34 (numpy ndarray subclasses)",
      default=False)
def points(dev, seed):
    rng = rng_of(seed)
    cs = dt.ScalarImage(torch.zeros((40, 56), device=dev or "cpu"), width=1.4, height=1.0).coordinatesystem
    vox = rng.integers(0, 40, (6, 2))
    v = dt.make_voxel(vox)
    c = dt.to_coordinate(v, cs)
    return {"coord": dt.Coordinate(c[0]), "coords": dt.CoordinateArray(c), "voxel": dt.Voxel(vox[0]),
            "voxels": dt.VoxelArray(vox), "center": dt.VoxelCenter(vox[0] + 0.5),
            "centers": dt.VoxelCenterArray(vox + 0.5), "make_c": dt.make_coordinate(c),
            "make_vc": dt.make_voxel_center(vox), "to_v": dt.to_voxel(c, cs), "to_vc": dt.to_voxel_center(c, cs)}


@case("AxisReduction", "reduce_axis", "extrude_along_axis", layer="image")
def dimension_reduction(dev, seed):
    rng = rng_of(seed)
    vol = scalar(rng.random((6, 10, 12)).astype(np.float32), dev, dim=3, dimensions=[0.6, 1.0, 1.2])
    flat = scalar(smooth(rng, (10, 12)), dev, width=1.2, height=1.0)
    return {"axis": dt.AxisReduction("z", 3, "average")(vol), "reduce": dt.reduce_axis(vol, "x", mode="sum"),
            "extrude": dt.extrude_along_axis(flat, 0.3, 4)}


@case("Resize", "resize", "resize_array", "equalize_voxel_size", "uniform_refinement", layer="image")
def resizes(dev, seed):
    rng = rng_of(seed)
    arr = smooth(rng, (48, 64), 3)
    img = optical(arr, dev, width=1.6, height=1.3)
    t = on(arr, dev) if dev is not None else arr
    return {"Resize": dt.Resize(fx=0.5, fy=0.5, **kw(dev))(img), "resize": dt.resize(img, shape=(30, 40)),
            "array": dt.resize_array(t, (24, 80)) if dev is not None else dt.Resize(shape=(24, 80))(arr),
            "area": dt.resize_array(on(arr, dev or "cuda"), (24, 32), "inter_area"),
            "lanczos": dt.resize_array(on(arr, dev or "cuda"), (40, 50), "lanczos3"),
            "equal": dt.equalize_voxel_size(img), "refine": dt.uniform_refinement(img, 1)}


# ================================================================ corrections


def checker_frame(seed, shape=(96, 144), swatch=8):
    """A uint8 frame of noise with the 2014 colour checker painted into its
    upper right corner, and the painted corners (row, col)."""
    ref = dt.ColorCheckerAfter2014().swatches_rgb
    frame = (smooth(rng_of(seed), shape, 3, 0.3, 0.7) * 255).astype(np.uint8)
    r0, c0 = 6, shape[1] - 6 - 6 * swatch
    frame[r0:r0 + 4 * swatch, c0:c0 + 6 * swatch] = (np.kron(ref, np.ones((swatch, swatch, 1))) * 255).astype(np.uint8)
    corners = np.array([[r0, c0], [r0 + 4 * swatch, c0], [r0 + 4 * swatch, c0 + 6 * swatch], [r0, c0 + 6 * swatch]])
    return frame, corners


CURVATURE = {
    "crop": {"pts_src": [[2, 3], [45, 2], [46, 62], [3, 63]], "width": 1.6, "height": 1.2},
    "bulge": {"horizontal_bulge": 2e-5, "vertical_bulge": 3e-5},
}


@case("CurvatureCorrection", "load_curvature_correction_config_from_dict", layer="corrections", warp=True, k1=10)
def curvature(dev, seed):
    rng = rng_of(seed)
    frame = smooth(rng, (48, 64), 3)
    config = dt.load_curvature_correction_config_from_dict({"curvature": {**CURVATURE, "use_cache": False}})
    correction = dt.CurvatureCorrection(config=CURVATURE)
    return {"img": optical(frame, dev, transformations=[correction], width=1.6, height=1.2),
            "config": sorted(config)}


@case("load_curvature_correction_config_from_toml", layer="corrections", where="host",
      cite="darsia_tpu/corrections/shape/curvature.py:92 (tomllib on the host)")
def curvature_toml(dev, seed):
    with scratch() as folder:
        (folder / "c.toml").write_text("[curvature]\nuse_cache = false\n[curvature.bulge]\nhorizontal_bulge = 1e-5\n")
        return {"config": str(sorted(dt.load_curvature_correction_config_from_toml(folder / "c.toml").items()))}


@case("DriftCorrection", "TranslationCorrection", layer="corrections", warp=True, k1=4)
def drift(dev, seed):
    rng = rng_of(seed)
    base = smooth(rng, (48, 64), 3)
    probe = np.roll(base, (1, 2), axis=(0, 1))
    drift = dt.DriftCorrection(optical(base, dev), {"roi": (slice(6, 42), slice(8, 56))})
    shift = dt.TranslationCorrection(np.array([1.5, -2.0]))
    return {"drift": optical(probe, dev, transformations=[drift]), "shift": optical(probe, dev, transformations=[shift])}


@case("RotationCorrection", "AffineCorrection", "GeneralizedPerspectiveCorrection", layer="corrections")
def shape_zoo(dev, seed):
    rng = rng_of(seed)
    frame = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    image = optical(frame, dev, width=3.2, height=2.4)
    cs = image.coordinatesystem
    src = np.asarray(cs.coordinate([[4, 6], [40, 8], [38, 60], [6, 56]]))
    dst_p = rng.random((16, 2)) * np.array([3.2, 2.4])
    src_p = (dst_p @ np.array([[1.002, 0.003], [-0.002, 0.999]]).T + 0.004) / (dst_p @ [2e-3, 1e-3] + 1)[:, None]
    return {
        "rotation": dt.RotationCorrection([24, 32], rotations=[np.deg2rad(0.5)])(image),
        "affine": dt.AffineCorrection(cs, cs, dt.make_coordinate(src), dt.make_coordinate(src + 0.03))(image),
        "perspective": dt.GeneralizedPerspectiveCorrection(
            cs, cs, dt.make_coordinate(src_p), dt.make_coordinate(dst_p))(image),
    }


@case("AffineTransformation", "GeneralizedPerspectiveTransformation", layer="corrections", where="host",
      cite="darsia_tpu/corrections/shape/affine.py:137, darsia_tpu/corrections/shape/generalizedperspective.py:60 (numpy points)")
def point_maps(dev, seed):
    rng = rng_of(seed)
    src = rng.random((12, 2))
    dst = src @ np.array([[1.01, 0.02], [-0.01, 0.99]]).T + 0.05
    affine = dt.AffineTransformation(2)
    affine.fit(src, dst)
    persp = dt.GeneralizedPerspectiveTransformation()
    cs = dt.ScalarImage(torch.zeros((40, 56)), width=1.4, height=1.0).coordinatesystem
    persp.fit(dt.make_coordinate(src), dt.make_coordinate(dst), {"coordinatesystem_dst": cs, "maxiter": 20})
    return {"affine": affine.call_array(src), "inverse": affine.inverse_array(dst), "persp": persp.inverse_array(src)}


@case("TransformationCorrection", layer="corrections")
def transformation_correction(dev, seed):
    rng = rng_of(seed)
    image = optical((rng.random((40, 56, 3)) * 255).astype(np.uint8), dev, width=1.4, height=1.0)
    cs = image.coordinatesystem
    src = rng.random((8, 2)) * [1.4, 1.0]
    affine = dt.AffineTransformation(2)
    affine.fit(dt.make_coordinate(src), dt.make_coordinate(src * 0.99 + 0.01))
    return {"img": dt.TransformationCorrection(cs, cs, affine)(image)}


@case("DeformationCorrection", layer="corrections", warp=True, k1=2)
def deformation(dev, seed):
    rng = rng_of(seed)
    base = smooth(rng, (64, 96), 3)
    probe = np.roll(base, (1, 2), axis=(0, 1))
    meta = {"width": 1.5, "height": 1.0}
    correction = dt.DeformationCorrection(optical(base, dev, **meta),
                                          {"N_patches": [2, 2], "rel_overlap": 0.2, "quality_tol": 0.01})
    return {"img": optical(probe, dev, transformations=[correction], **meta)}


@case("PiecewisePerspectiveTransform", layer="corrections", warp=True, k1=2)
def piecewise(dev, seed):
    rng = rng_of(seed)
    image = optical(smooth(rng, (48, 64), 3), dev, width=3.2, height=2.4)
    patches = dt.Patches(image, [3, 4], rel_overlap=0.1)
    return {"img": dt.PiecewisePerspectiveTransform().find_and_warp(patches, rng.uniform(-2, 2, (3, 4, 2)))}


@case("ColorCorrection", "find_colorchecker", "CustomColorChecker", layer="corrections", warp=True, k1=4)
def color_correction(dev, seed):
    frame, _ = checker_frame(seed)
    image = optical(frame, dev)
    checker, voxels = dt.find_colorchecker(image)
    correction = dt.ColorCorrection(image, {"roi": voxels})
    probe = np.clip(frame.astype(np.float32) * 0.9 + 10, 0, 255).astype(np.uint8)
    return {"voxels": voxels, "swatches": checker.swatches_rgb, "img": optical(probe, dev, transformations=[correction])}


@case("ColorChecker", "ClassicColorChecker", "ColorCheckerAfter2014", layer="corrections", where="host",
      cite="darsia_tpu/corrections/color/colorcorrection.py:46-140 (numpy reference swatches)")
def color_checkers(dev, seed):
    return {"classic": dt.ClassicColorChecker().swatches_rgb, "after": dt.ColorCheckerAfter2014().swatches_RGB,
            "base": dt.ColorChecker.__name__}


@case("ExperimentalColorCorrection", "EOTF", layer="corrections", warp=True, k1=2)
def experimental_color(dev, seed):
    ref = dt.ColorCheckerAfter2014().swatches_rgb
    checker = np.kron(ref, np.ones((12, 12, 1))).astype(np.float32) * np.array([0.9, 1.0, 0.8], np.float32)
    image = optical(checker, dev, width=2.4, height=1.6)
    eotf = dt.EOTF()
    return {"img": dt.ExperimentalColorCorrection()(image), "eotf": eotf.adjust(image.img),
            "inverse": eotf.inverse_approx(image.img)}


@case("IlluminationCorrection", layer="corrections", rtol=2e-3, atol=1e-5)
def illumination(dev, seed):
    # A light field constant on 8x8 blocks: the samples' characteristic
    # colours (the most common k-means cluster of each patch) are then set
    # by the patches' geometry.  On a textured patch the clusters' sizes
    # nearly tie and a last-bit difference of the colour conversion picks
    # another cluster (1.8e-3 apart on an H100), which the flat fit of the
    # scalings (L-BFGS-B at an objective of 6e-7) spreads to 3% of the
    # corrected image.  Even so the scalings' fit, stopped by L-BFGS-B's
    # relative reduction of an objective of order 1e-7, moves by up to 5e-4
    # relative between an H100 and the CPU: the tolerance.
    rng = rng_of(seed)
    blocks_rgb = smooth(rng, (6, 8), 3, 0.2, 0.8, noise=0.0)
    frame = (np.kron(blocks_rgb, np.ones((8, 8, 1))) * 255).astype(np.uint8)
    base = optical(frame, dev)
    correction = dt.IlluminationCorrection()
    cfg = type("Cfg", (), {"width": 8, "num_samples": 12, "seed": 42})()
    samples = correction.select_random_samples(np.ones((48, 64), bool), cfg)
    correction.setup(base, [samples], interpolation="quartic")
    return {"img": optical(frame, dev, transformations=[correction])}


@case("PatchwiseIlluminationCorrection", layer="corrections")
def patchwise_illumination(dev, seed):
    rng = rng_of(seed)
    frame = smooth(rng, (48, 64), 3, 0.2, 0.8)
    image, others = optical(frame, dev), [optical(frame * 0.95, dev)]
    correction = dt.PatchwiseIlluminationCorrection(image, others, nw=16, limit=8)
    return {"img": correction.correct_array(image.img)}


@case("DynamicIlluminationCorrection", layer="corrections")
def dynamic_illumination(dev, seed):
    rng = rng_of(seed)
    base = (smooth(rng, (48, 64), 3, 0.2, 0.8) * 255).astype(np.uint8)
    correction = dt.DynamicIlluminationCorrection()
    correction.setup(optical(base, dev).img, [(slice(5, 15), slice(5, 15)), (slice(20, 30), slice(30, 40))])
    probe = (base * 0.7).astype(np.uint8)
    return {"colors": correction.base_colors, "img": optical(probe, dev, transformations=[correction])}


@case("RelativeColorCorrection", layer="corrections", rtol=1e-4, atol=1e-5)
def relative_color(dev, seed):
    rng = rng_of(seed)
    frame = smooth(rng, (48, 64), 3)
    image = optical(frame, dev, width=3.2, height=2.4)
    correction = dt.RelativeColorCorrection(image, config={"degree": 1})
    correction.add_calibration_data(rng.random((30, 2)) * [3.2, 2.4], rng.random((30, 3)), [0.5, 0.5, 0.5])
    correction.calibrate()
    correction.setup()
    return {"img": correction(image)}


@case("TypeCorrection", "read_correction", "BaseCorrection", layer="corrections", warp=True, k1=2)
def type_and_files(dev, seed):
    rng = rng_of(seed)
    frame = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    with scratch() as folder:
        dt.TranslationCorrection(np.array([1.0, -2.0])).save(folder / "t.npz")
        back = dt.read_correction(folder / "t.npz")
        return {"type": optical(frame, dev, transformations=[dt.TypeCorrection(torch.float32)]),
                "read": back.correct_array(optical(frame, dev).img.to(torch.float32))}


@case("WhiteBalance", "ColorBalance", "AffineBalance", "AdaptiveBalance", "color_balance", "white_balance",
      "affine_balance", layer="corrections", default=False)
def balances(dev, seed):
    # default=False: numpy in, numpy out (tests/test_torch_color_corrections.py::test_balances_against_jax).
    rng = rng_of(seed)
    src = rng.random((18, 3))
    dst = src @ np.array([[0.9, 0.05, 0.0], [0.1, 1.1, 0.0], [0.0, 0.02, 0.97]]) + 0.01
    img = torch.as_tensor(rng.random((20, 30, 3)).astype(np.float32), device=dev)
    out = {}
    for cls in (dt.WhiteBalance, dt.ColorBalance, dt.AffineBalance, dt.AdaptiveBalance):
        balance = cls()
        balance.find_balance(src, dst)
        out[cls.__name__] = balance.apply_balance(img)
    for fn in (dt.color_balance, dt.white_balance, dt.affine_balance):
        out[fn.__name__] = fn(img, src, dst)
    return out


@case("extract_quadrilateral_ROI", "quad_coordinate_grid", "homography_from_points", "sort_quad",
      layer="corrections", warp=True, k1=2)
def quadrilateral(dev, seed):
    rng = rng_of(seed)
    frame = smooth(rng, (48, 64), 3, noise=0.0)  # the gate's smooth image (chip_smoke.py::smooth_image)
    pts = np.array([[4.5, 4.25], [43.0, 3.5], [43.75, 59.5], [3.5, 60.0]])
    image = optical(frame, dev)
    return {
        "linear": dt.extract_quadrilateral_ROI(image.img, pts_src=pts, indexing="matrix", shape=(40, 56)),
        "nearest": dt.extract_quadrilateral_ROI(image.img, pts_src=pts, indexing="matrix",
                                                interpolation="inter_nearest", shape=(40, 56)),
        "grid": dt.quad_coordinate_grid(pts, (40, 56), **kw(dev or "cuda")),
        "H": dt.homography_from_points(pts, pts * 0.9 + 1),
        "sorted": np.asarray(dt.sort_quad(pts[[2, 0, 3, 1]])),
    }


@case("TranslationEstimator", layer="corrections", default=False)
def translation_estimator(dev, seed):
    rng = rng_of(seed)
    base = torch.as_tensor(smooth(rng, (64, 96), 3), device=dev)
    probe = torch.roll(base, (2, 3), dims=(0, 1))
    roi = (slice(8, 56), slice(8, 88))
    return {"translation": dt.TranslationEstimator().find_effective_translation(probe, base, roi, roi)}


# ================================================================ restoration and solvers


def blocks(rng, shape, noise=0.1) -> np.ndarray:
    """Piecewise-constant 8-voxel blocks with noise, in [0, 1] (float32)."""
    coarse = rng.random(tuple(-(-n // 8) for n in shape))
    img = np.kron(coarse, np.ones((8,) * len(shape)))[tuple(slice(0, n) for n in shape)]
    return np.clip(img + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)


@case("TVD", "tvd", layer="restoration", rtol=1e-4, atol=2e-5)
def tvd_methods(dev, seed):
    rng = rng_of(seed)
    img = scalar(blocks(rng, (48, 64)), dev, width=1.0, height=0.75)
    out = {"chambolle": dt.TVD(method="chambolle", weight=0.1, max_num_iter=15, eps=0.0)(img)}
    for method in ("anisotropic bregman", "isotropic bregman"):
        out[method] = dt.tvd(img, method=method, weight=5.0, max_num_iter=10, eps=None)
    return out


@case("split_bregman_tvd", "chambolle_tvd", layer="restoration", rtol=1e-4, atol=2e-5)
def tvd_functions(dev, seed):
    rng = rng_of(seed)
    vol = on(blocks(rng, (12, 16, 20)), dev)
    flat = on(blocks(rng, (48, 64)), dev)
    return {"bregman": dt.split_bregman_tvd(vol, mu=0.2, omega=1.0, dim=3, max_num_iter=10, isotropic=True, **kw(dev)),
            "chambolle": dt.chambolle_tvd(flat if dev is not None else torch.as_tensor(flat, device="cuda"),
                                          weight=0.15, eps=0.0, max_num_iter=15)}


@case("H1_regularization", "Jacobi", "CG", "MG", "Solver", layer="restoration", rtol=1e-4, atol=2e-5)
def linear_solvers(dev, seed):
    rng = rng_of(seed)
    img = scalar(blocks(rng, (32, 48)), dev, width=1.0, height=0.75)
    rhs = torch.as_tensor(blocks(rng, (32, 48)), device=dev or "cuda")
    x0 = torch.zeros_like(rhs)
    diffusion = rng.uniform(0.5, 1.5, (32, 48)).astype(np.float32)
    return {
        "h1": dt.H1_regularization(img, mu=0.5, omega=1.0, solver=dt.Jacobi(maxiter=10), **kw(dev)),
        "jacobi": dt.Jacobi(maxiter=10, mass_coeff=1.0, diffusion_coeff=diffusion)(x0, rhs),
        "cg": dt.CG(maxiter=20, mass_coeff=1.0, diffusion_coeff=0.5)(x0, rhs, h=1.0),
        "mg": dt.MG(depth=2, maxiter=3, mass_coeff=1.0, diffusion_coeff=0.5)(x0, rhs),
        "solver": issubclass(dt.MG, dt.Solver),
    }


@case("Median", "median_filter", layer="restoration")
def median(dev, seed):
    rng = rng_of(seed)
    img = scalar(blocks(rng, (40, 56)), dev)
    return {"median": dt.Median(disk_radius=2)(img), "filter": dt.median_filter(img.img, disk_radius=1, **kw(dev))}


@case("REV", "VolumeAveraging", "volume_average", "uniform_filter", layer="restoration")
def volume_averaging(dev, seed):
    rng = rng_of(seed)
    img = scalar(blocks(rng, (40, 56)), dev, width=1.4, height=1.0)
    mask = on(rng.random((40, 56)) > 0.2, dev)
    rev = dt.REV(size=0.1, img=img)
    return {"averaged": dt.VolumeAveraging(rev, mask, **kw(dev))(img), "volume": dt.volume_average(img, mask, 0.1),
            "uniform": dt.uniform_filter(img.img, 5)}


@case("porosity_based_averaging", layer="restoration")
def porosity_averaging(dev, seed):
    rng = rng_of(seed)
    ref = scalar(blocks(rng, (40, 56)), dev, width=1.4, height=1.0)
    labels = on(np.repeat(np.arange(4), 14)[None, :].repeat(40, 0).astype(np.int32), dev)
    porosity = on(rng.uniform(0.2, 0.5, (40, 56)).astype(np.float32), dev)
    averaging = dt.porosity_based_averaging(labels, porosity, ref, threshold=0.3, disk_size=2, rev_size=0.05)
    return {"averaged": averaging(ref)}


@case("BinaryFillHoles", "BinaryLocalConvexCover", "BinaryRemoveSmallObjects", layer="restoration",
      where="host", cite="darsia_tpu/restoration/binaryinpaint.py:34,51,67 (numpy masks)")
def binary_cleaners(dev, seed):
    rng = rng_of(seed)
    mask = blocks(rng, (40, 56), 0.0) > 0.5
    mask[rng.random((40, 56)) > 0.97] ^= True
    return {"fill": dt.BinaryFillHoles(area_threshold=6)(mask),
            "cover": dt.BinaryLocalConvexCover(cover_patch_size=8)(mask),
            "remove": dt.BinaryRemoveSmallObjects(min_size=5)(mask)}


@case("laplace", "fv_laplace", "forward_diff", "backward_diff", layer="restoration", default=False)
def derivatives(dev, seed):
    rng = rng_of(seed)
    img = torch.as_tensor(blocks(rng, (32, 40)), device=dev)
    coeff = torch.as_tensor(rng.uniform(0.5, 1.5, (32, 40)).astype(np.float32), device=dev)
    return {"laplace": dt.laplace(img, h=0.1), "fv": dt.fv_laplace(img, diffusion_coeff=coeff),
            "forward": dt.forward_diff(img, 0), "backward": dt.backward_diff(img, 1, h=0.5)}


@case("linalg_cg", "linalg_gmres", layer="restoration", rtol=1e-4, atol=1e-5)
def krylov_operators(dev, seed):
    rng = rng_of(seed)
    diag = rng.uniform(1.0, 2.0, 64).astype(np.float32)
    b = rng.random(64).astype(np.float32)

    def operator(x):
        return x * torch.as_tensor(diag, device=x.device) + 0.1 * torch.roll(x, 1)

    return {"cg": dt.linalg_cg(operator, b, maxiter=40, **kw(dev)),
            "gmres": dt.linalg_gmres(operator, b, maxiter=5, **kw(dev))}


@case("KSP", layer="restoration", where="host", cite="darsia_tpu/utils/linalg.py:87 (KSP: scipy sparse on the host)")
def ksp(dev, seed):
    import scipy.sparse as sps

    rng = rng_of(seed)
    A = sps.diags([rng.uniform(2, 3, 30), -np.ones(29), -np.ones(29)], [0, 1, -1])
    solver = dt.KSP(A)
    solver.setup({"ksp_type": "cg", "ksp_rtol": 1e-10})
    return {"x": solver.solve(rng.random(30))}


@case("AndersonAcceleration", layer="restoration", where="host",
      cite="darsia_tpu/utils/andersonacceleration.py:110-150 (numpy history)")
def anderson(dev, seed):
    rng = rng_of(seed)
    aa = dt.AndersonAcceleration(dimension=10, depth=3)
    x = rng.random(10)
    for k in range(6):
        gx = 0.5 * np.cos(x)
        x = aa(gx, gx - x, k)
    return {"x": x}


# ================================================================ signals and models


def stripe_labels(shape=(40, 56), n=4) -> np.ndarray:
    """Vertical stripes of labels 0..n-1 (int32)."""
    cols = np.minimum(np.arange(shape[1]) * n // shape[1], n - 1)
    return np.broadcast_to(cols, shape).astype(np.int32).copy()


@case("LinearModel", "ScalingModel", "ClipModel", "CombinedModel", "Model", layer="signals")
def linear_models(dev, seed):
    rng = rng_of(seed)
    signal = on(rng.uniform(-0.2, 1.2, (40, 56)).astype(np.float32), dev)
    chain = dt.CombinedModel([dt.LinearModel(scaling=2.0, offset=0.1), dt.ClipModel(0.0, 1.5)])
    return {"linear": dt.LinearModel(scaling=1.5)(signal), "scaling": dt.ScalingModel(key="m ", **{"m scaling": 1.7})(signal),
            "clip": dt.ClipModel(0.0, 1.0)(signal), "chain": chain(signal),
            "model": isinstance(chain, dt.Model)}


@case("HeterogeneousLinearModel", "HeterogeneousModel", layer="signals")
def heterogeneous_models(dev, seed):
    rng = rng_of(seed)
    signal = on(rng.uniform(0, 1, (40, 56)).astype(np.float32), dev)
    labels = on(stripe_labels(), dev)
    linear = dt.HeterogeneousLinearModel(labels, scaling=[0.5, 1.0, 1.5, 2.0], offset=0.1)
    return {"linear": linear(signal), "clip": dt.HeterogeneousModel(dt.ClipModel(0.2, 0.6), labels)(signal)}


@case("PWTransformation", layer="signals")
def pw_transformation(dev, seed):
    rng = rng_of(seed)
    signal = on(rng.uniform(0, 1, (40, 56)).astype(np.float32), dev)
    pw = dt.PWTransformation(supports=[0.0, 0.5, 1.0], values=[0.0, 0.8, 1.0])
    return {"out": pw(signal), "inverse": pw.inverse(0.4)}


@case("KernelInterpolation", "AdvancedKernelInterpolation", "GaussianKernel", "LinearKernel", layer="signals",
      rtol=1e-5, atol=1e-6)
def kernel_interpolation(dev, seed):
    rng = rng_of(seed)
    supports = rng.random((8, 3)).astype(np.float32)
    values = rng.random(8)
    signal = on(rng.random((20, 24, 3)).astype(np.float32), dev)
    gauss = dt.KernelInterpolation(dt.GaussianKernel(gamma=4.0), supports, values)
    advanced = dt.AdvancedKernelInterpolation(dt.LinearKernel(a=0.1))
    advanced.update(supports=supports, values=values)
    x = on(supports, dev)
    return {"gauss": gauss(signal), "linear": advanced(signal),
            "kernel": dt.GaussianKernel(gamma=2.0)(x, x), "combination": dt.LinearKernel(a=0.1).linear_combination(
                signal, x, on(values.astype(np.float32), dev))}


@case("ThresholdModel", "StaticThresholdModel", "DynamicThresholdModel", layer="signals")
def threshold_models(dev, seed):
    rng = rng_of(seed)
    signal = np.concatenate([rng.normal(0.2, 0.05, (20, 56)), rng.normal(0.7, 0.05, (20, 56))]).astype(np.float32)
    img = scalar(signal, dev, width=1.4, height=1.0)
    labels = on(stripe_labels(), dev)
    static = dt.StaticThresholdModel([0.3, 0.4, 0.5, 0.6], [0.9] * 4, labels=labels, return_float=True)
    dynamic = dt.DynamicThresholdModel(method="otsu", threshold_min=0.0, threshold_max=1.0)
    return {"static": static(img), "dynamic": dynamic(img),
            "threshold": dt.ThresholdModel(labels, key="p ", **{"p threshold value": [0.3, 0.4, 0.5, 0.6]})(img)}


@case("otsu_threshold", "StandardOtsu", "OtsuTwoPeakHistogrammAnalysis", "TwoPeakHistogrammAnalysis",
      "GlobalMinTwoPeakHistogrammAnalysis", "HistogrammBasedThresholding", layer="signals",
      where="host", cite="darsia_tpu/signals/models/dynamicthresholdmodel.py:29 (numpy histograms)")
def histogram_thresholds(dev, seed):
    rng = rng_of(seed)
    values = np.concatenate([rng.normal(0.25, 0.05, 2000), rng.normal(0.7, 0.08, 1500)]).astype(np.float32)
    out = {"otsu": dt.otsu_threshold(values)}
    for cls in (dt.StandardOtsu, dt.OtsuTwoPeakHistogrammAnalysis, dt.TwoPeakHistogrammAnalysis,
                dt.GlobalMinTwoPeakHistogrammAnalysis):
        out[cls.__name__] = cls()(values)
    out["base"] = issubclass(dt.StandardOtsu, dt.HistogrammBasedThresholding)
    return out


@case("BinaryDataSelector", "ValueCriterion", "RelativeValueCriterion", "GradientModulusCriterion",
      "TransformedValueCriterion", "CombinedCriterion", "BaseCriterion", layer="signals", where="host",
      cite="darsia_tpu/signals/models/binarydataselector.py:124 (scipy.ndimage regions on numpy)")
def binary_data_selector(dev, seed):
    rng = rng_of(seed)
    signal = rng.uniform(0.0, 0.01, (48, 64))
    mask = np.zeros((48, 64), bool)
    for k, (r, c, size) in enumerate([(8, 8, 6), (30, 10, 8), (10, 40, 5), (35, 45, 9)]):
        signal[r:r + size, c:c + size] += (0.01 + 0.02 * k) * (1 + rng.uniform(0, 1, (size, size)))
        mask[r:r + size, c:c + size] = True
    diff = rng.uniform(0, 0.1, (48, 64, 3)).astype(np.float32)
    signal = on(signal.astype(np.float32), dev)
    args = (signal, on(mask, dev), on(diff, dev))
    combined = dt.CombinedCriterion([dt.ValueCriterion(0.04), dt.RelativeValueCriterion(2.0)])
    return {
        "combined": dt.BinaryDataSelector(combined)(*args),
        "gradient": dt.BinaryDataSelector(dt.GradientModulusCriterion(0.02))(*args),
        "transformed": dt.BinaryDataSelector(dt.TransformedValueCriterion(lambda x: x[..., 2], 0.05))(*args),
    }


def near_path(rng, path, shape, noise=0.01) -> np.ndarray:
    """Colours along ``path`` with a little noise (float32): the closest
    segment is not a tie, as for the colours a calibrated path meets."""
    knots = np.stack(path.colors)
    t = rng.uniform(0, len(knots) - 1, shape)
    k = np.minimum(t.astype(int), len(knots) - 2)
    colors = knots[k] + (t - k)[..., None] * (knots[k + 1] - knots[k])
    return (colors + noise * rng.standard_normal(shape + (3,))).astype(np.float32)


@case("ColorPath", "define_color_path", layer="signals")
def color_path(dev, seed):
    rng = rng_of(seed)
    path = dt.ColorPath(colors=[np.zeros(3), np.array([0.2, 0.1, 0.4]), np.array([0.5, 0.6, 0.2])])
    colors = on(near_path(rng, path, (24, 32)), dev)
    mask = on(rng.random((24, 32)) > 0.5, dev)
    params = path.fit(colors, dt.ColorMode.RELATIVE)
    defined = dt.define_color_path(colors, mask, num_colors=3)
    return {"fit": params, "interpret": path.interpret(params, dt.ColorMode.RELATIVE),
            "defined": np.stack(defined.colors)}


@case("ColorPathFunction", "ColorPathInterpolation", "LabelColorPathInterpolation", layer="signals")
def color_path_interpolation(dev, seed):
    rng = rng_of(seed)
    path = dt.ColorPath(colors=[np.zeros(3), np.array([0.2, 0.1, 0.4]), np.array([0.5, 0.6, 0.2])])
    colors = on(near_path(rng, path, (40, 56)), dev)
    paths = {label: path for label in range(4)}
    values = {label: [0.0, 0.3 + 0.1 * label, 1.0] for label in range(4)}
    return {
        "function": dt.ColorPathFunction(path, dt.ColorMode.RELATIVE)(colors),
        "interp": dt.ColorPathInterpolation(path, dt.ColorMode.RELATIVE, values=[0.0, 0.4, 1.0])(colors),
        "labels": dt.LabelColorPathInterpolation(paths, on(stripe_labels(), dev), dt.ColorMode.RELATIVE, values)(colors),
    }


@case("ColorRange", "ColorSpectrum", "DiscreteColorRange", layer="signals", where="host",
      cite="darsia_tpu/signals/color/color_range.py:83-460 (numpy; a tensor stays on its device in the port)")
def color_ranges(dev, seed):
    rng = rng_of(seed)
    colors = rng.uniform(0.1, 0.6, (200, 3)).astype(np.float32)
    probe = on(rng.uniform(0, 0.8, (20, 24, 3)).astype(np.float32), dev)
    spectrum = dt.ColorSpectrum(resolution=11, base_color=[0.1, 0.2, 0.3]).fit(colors)
    discrete = dt.DiscreteColorRange(resolution=11).fit(colors)
    return {"range": dt.ColorRange().fit(colors, expand=0.1).contains(probe),
            "distance": spectrum.distance(probe), "in": spectrum.in_spectrum(probe, dt.ColorMode.RELATIVE),
            "discrete": discrete.contains(probe), "occupancy": discrete.colors()}


@case("color_to_index", "color_to_index_numba", "flatten_index", "flatten_index_numba", "unflatten_index",
      "index_to_color", layer="signals", where="host", cite="darsia_tpu/signals/color/color_range.py:27-80 (numpy)")
def color_indices(dev, seed):
    colors = rng_of(seed).uniform(0, 1, (50, 3))
    index = dt.color_to_index(colors, 11)
    flat = dt.flatten_index(index, 11)
    return {"index": index, "numba": dt.color_to_index_numba(colors, 11), "flat": flat,
            "flat_numba": dt.flatten_index_numba(index, 11), "unflat": dt.unflatten_index(flat, 11),
            "color": dt.index_to_color(index, 11)}


@case("LabelColorMap", "LabelColorPathMap", "LabelColorSpectrumMap", layer="signals", where="host",
      cite="darsia_tpu/signals/color/label_maps.py:20-98 (dicts of numpy colours, paths and spectra)")
def label_maps(dev, seed):
    rng = rng_of(seed)
    path = dt.ColorPath(colors=[np.zeros(3), np.array([0.2, 0.1, 0.4])])
    spectrum = dt.ColorSpectrum(resolution=11).fit(rng.uniform(0, 0.5, (40, 3)))
    with scratch() as folder:
        dt.LabelColorMap({0: rng.random(3), 1: rng.random(3)}).save(folder / "colors")
        dt.LabelColorPathMap({0: path, 1: path}).save(folder / "paths")
        dt.LabelColorSpectrumMap({0: spectrum}).save(folder / "spectra")
        colors = dt.LabelColorMap.load(folder / "colors")
        paths = dt.LabelColorPathMap.load(folder / "paths")
        spectra = dt.LabelColorSpectrumMap.load(folder / "spectra")
    return {"mean": colors.mean(), "paths": np.stack(paths[1].colors), "occupancy": spectra[0].colors}


@case("LabelColorPathMapRegression", layer="signals", rtol=1e-4, atol=1e-6)
def color_path_regression(dev, seed):
    rng = rng_of(seed)
    labels = scalar(stripe_labels((40, 56), 2), dev)
    base = optical(smooth(rng, (40, 56), 3, 0.3, 0.5), dev)
    plume = smooth(rng, (40, 56), 3, 0.3, 0.5)
    plume[10:30, 10:46] += np.array([0.2, 0.05, -0.1], np.float32)
    regression = dt.LabelColorPathMapRegression(labels, resolution=11)
    spectra = regression.get_color_spectrum([optical(np.clip(plume, 0, 1), dev)], baseline=base, threshold_zero=0.01)
    paths = regression.find_color_path(spectra, num_segments=2)
    return {"paths": [np.stack(paths[k].colors) for k in sorted(paths)]}


@case("normalized_trichromatic", "channel_index", "parse_color_embedding_basis", "calibration_basis_folder",
      layer="signals")
def color_embedding_helpers(dev, seed):
    rng = rng_of(seed)
    image = optical(smooth(rng, (24, 32), 3), dev)
    base = optical(smooth(rng, (24, 32), 3), dev)
    hsv, cs = dt.normalized_trichromatic(image, "HSV", dt.ColorMode.ABSOLUTE)
    rel, _ = dt.normalized_trichromatic(image, "RGB", dt.ColorMode.RELATIVE, baseline=base)
    return {"hsv": hsv, "cs": cs, "relative": rel, "index": dt.channel_index("HSV", "v"),
            "basis": dt.parse_color_embedding_basis("labels").value,
            "folder": dt.calibration_basis_folder(dt.ColorEmbeddingBasis.FACIES)}


@case("get_mean_color", "MonochromaticReduction", "SignalReduction", layer="signals")
def reductions(dev, seed):
    rng = rng_of(seed)
    rgb = on(smooth(rng, (24, 32), 3), dev)
    mask = on(rng.random((24, 32)) > 0.3, dev)
    return {"mean": dt.get_mean_color(rgb, mask), "gray": dt.MonochromaticReduction(color="gray")(rgb),
            "blue": dt.MonochromaticReduction(color="blue")(rgb), "red": dt.MonochromaticReduction(color="red")(rgb),
            "base": issubclass(dt.MonochromaticReduction, dt.SignalReduction)}


# ================================================================ analysis and measure


def plume_frames(seed, shape=(64, 96)):
    """(baseline, probe) float32 RGB frames: a smooth scene and a darker
    plume, the probe shifted by (1, 2) voxels."""
    rng = rng_of(seed)
    base = smooth(rng, shape, 3, 0.35, 0.6)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    plume = np.exp(-(((yy - shape[0] * 0.6) / 10) ** 2 + ((xx - shape[1] * 0.4) / 18) ** 2))
    probe = np.roll(base, (1, 2), axis=(0, 1)) - 0.2 * plume[..., None].astype(np.float32)
    return base, np.clip(probe, 0, 1).astype(np.float32)


def concentration_analysis(base):
    return dt.ConcentrationAnalysis(base=base, signal_reduction=dt.MonochromaticReduction(color="gray"),
                                    model=dt.LinearModel(scaling=2.0))


@case("ConcentrationAnalysis", "PriorPosteriorConcentrationAnalysis", layer="analysis")
def concentration(dev, seed):
    base_np, probe_np = plume_frames(seed)
    meta = {"width": 1.5, "height": 1.0}
    base, probe = optical(base_np, dev, **meta), optical(probe_np, dev, **meta)
    restoration = dt.CombinedModel([dt.Resize(fx=0.5, fy=0.5, **kw(dev)), dt.TVD(max_num_iter=3),
                                    dt.Resize(shape=(64, 96), **kw(dev))])
    plain = concentration_analysis(base)
    posterior = dt.PriorPosteriorConcentrationAnalysis(
        base, dt.MonochromaticReduction(color="gray"), None, restoration, dt.LinearModel(scaling=2.0),
        lambda s, prior, diff: s * prior)
    return {"plain": plain(probe), "posterior": posterior(probe)}


@case("FusedAnalysisPipeline", "ImageRegistration", layer="analysis", warp=True, k1=8)
def fused_pipeline(dev, seed):
    base_np, probe_np = plume_frames(seed)
    meta = {"width": 1.5, "height": 1.0}
    base = optical(base_np, dev, **meta)
    correction = dt.CurvatureCorrection(config={"bulge": {"horizontal_bulge": 2e-5, "vertical_bulge": 3e-5}})
    registration = dt.ImageRegistration(base, N_patches=[2, 3], rel_overlap=0.2, quality_tol=0.01)
    pipeline = dt.FusedAnalysisPipeline(transformations=[correction], registration=registration,
                                        analysis=concentration_analysis(base), max_disp=16)
    out = pipeline(probe_np if dev is None else torch.as_tensor(probe_np, device=dev))
    return {"conc": out, "displacement": registration.displacement()}


@case("DiffeomorphicImageRegistration", "MultiscaleDiffeomorphicImageRegistration", "TranslationAnalysis",
      layer="analysis", warp=True, k1=8)
def registrations(dev, seed):
    base_np, probe_np = plume_frames(seed)
    meta = {"width": 1.5, "height": 1.0}
    base, probe = optical(base_np, dev, **meta), optical(probe_np, dev, **meta)
    kwargs = {"N_patches": [2, 3], "rel_overlap": 0.2, "quality_tol": 0.01}
    flexible = dt.DiffeomorphicImageRegistration(base, fused=False, **kwargs)
    multiscale = dt.MultiscaleDiffeomorphicImageRegistration(base, num_levels=2, **kwargs)
    translation = dt.TranslationAnalysis(base, **kwargs)
    return {"flexible": flexible(probe), "flex_disp": flexible.displacement(), "multiscale": multiscale(probe),
            "translation": translation(probe), "points": flexible.evaluate(np.array([[10.0, 20.0], [30.0, 50.0]]),
                                                                            units="pixel")}


def blob_mask(shape=(40, 56), seed=0) -> np.ndarray:
    rng = rng_of(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    mask = np.zeros(shape, bool)
    for _ in range(3):
        r, c, rad = rng.integers(8, shape[0] - 8), rng.integers(8, shape[1] - 8), rng.integers(4, 8)
        mask |= (yy - r) ** 2 + (xx - c) ** 2 <= rad ** 2
    return mask


def finger_mask(shape=(48, 64), rise=0) -> np.ndarray:
    mask = np.zeros(shape, bool)
    mask[30:, :] = True
    for k, c in enumerate((10, 26, 42, 56)):
        mask[14 - rise - 3 * (k % 2):30, c - 3:c + 3] = True
    return mask


@case("ContourAnalysis", "contour_length", "ContourSmootherSequence", "GaussianSmoother", "MovingAverageSmoother",
      "PolyDPSmoother", "SavitzkyGolaySmoother", layer="analysis", needs="cv2", default=False)
def contours(dev, seed):
    # default=False: a numpy mask stays on the host; the contours are OpenCV's.
    mask = torch.as_tensor(finger_mask(), device=dev)
    out = {}
    smoothers = {"gauss": dt.GaussianSmoother(window_length=5), "moving": dt.MovingAverageSmoother(window=5),
                 "polydp": dt.PolyDPSmoother(epsilon=0.01), "savgol": dt.SavitzkyGolaySmoother(window_length=7),
                 "sequence": dt.ContourSmootherSequence([dt.MovingAverageSmoother(window=3),
                                                         dt.GaussianSmoother(window_length=5)])}
    for name, smoother in smoothers.items():
        analysis = dt.ContourAnalysis(contour_smoother=smoother)
        analysis.load(mask)
        out[name] = [analysis.length(), analysis.number_peaks(), analysis.number_valleys()]
    out["length"] = dt.contour_length(mask)
    return out


@case("extract_lower_arc", layer="analysis", where="host", cite="darsia_tpu/analysis/contouranalysis.py:18 (numpy)")
def lower_arc(dev, seed):
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    contour = np.stack([30 + 12 * np.cos(t), 20 + 12 * np.sin(t)], 1).round().astype(np.int32)[:, None, :]
    return {"arc": dt.extract_lower_arc(contour)}


@case("SkeletonAnalysis", "PathEvolutionAnalysis", "PathUnit", layer="analysis")
def skeleton(dev, seed):
    skeleton = dt.SkeletonAnalysis(**kw(dev))
    skeleton.load(on(finger_mask(), dev))
    tracker = dt.PathEvolutionAnalysis(**kw(dev))
    rows = [tracker.add_mask(on(finger_mask(rise=4 * k), dev), time=float(k)) for k in range(3)]
    tracker.find_paths()
    return {"skeleton": skeleton.skeleton_mask, "length": skeleton.skeleton_length(),
            "endpoints": skeleton.endpoints(), "branches": skeleton.branch_points(),
            "rows": [sorted((k, str(v)) for k, v in row.items()) for row in rows], "advance": tracker.tip_advance(),
            "rates": str(tracker.advance_rates()), "counts": str(tracker.path_counts(2)),
            "units": [type(u).__name__ == "PathUnit" for path in tracker.paths for u in path][:3]}


@case("SegmentationComparison", layer="analysis")
def segmentation_comparison(dev, seed):
    masks = [on(blob_mask(seed=seed + k), dev) for k in range(3)]
    comparison = dt.SegmentationComparison(3, **kw(dev))
    rgb = comparison(*masks)
    return {"rgb": rgb, "code": comparison.compare_segmentations_binary_array(*masks),
            "fractions": str(comparison.color_fractions(rgb)), "overlap": comparison.overlap(masks[0], masks[1])}


@case("Geometry", "WeightedGeometry", "PorousGeometry", "ExtrudedGeometry", "ExtrudedPorousGeometry",
      layer="analysis", rtol=1e-6, atol=1e-9)
def geometries(dev, seed):
    rng = rng_of(seed)
    img = scalar(smooth(rng, (40, 56)), dev, width=1.4, height=1.0)
    meta = img.shape_metadata()
    weight = on(rng.uniform(0.2, 0.5, (40, 56)).astype(np.float32), dev)
    porous = dt.ExtrudedPorousGeometry(np.full((40, 56), 0.44), np.full((40, 56), 0.02), **meta)
    return {"plain": dt.Geometry(**meta).integrate(img), "weighted": dt.WeightedGeometry(weight, **meta).integrate(img),
            "porous": dt.PorousGeometry(0.5, **meta).integrate(img),
            "extruded": dt.ExtrudedGeometry(0.02, **meta).integrate(img), "extruded_porous": porous.integrate(img),
            "normalized": dt.Geometry(**meta).normalize(img, img)}


def two_blocks(n=16):
    src, dst = np.zeros((n, n), np.float32), np.zeros((n, n), np.float32)
    src[2:6, 2:6] = 1.0
    dst[n - 7:n - 3, n - 6:n - 2] = 1.0
    return src / src.sum(), dst / dst.sum()


W1_NEWTON = {"num_iter": 30, "tol_distance": 1e-6, "L": 1e9}


@case("wasserstein_distance", "BeckmannNewtonSolver", "BeckmannProblem", "BeckmannConvergenceCriteria",
      "BeckmannConvergenceHistory", layer="analysis", rtol=1e-4, atol=1e-6)
def wasserstein_newton(dev, seed):
    src, dst = two_blocks()
    meta = {"width": 1.0, "height": 1.0}
    a, b = scalar(src, dev, **meta), scalar(dst, dev, **meta)
    distance, info = dt.wasserstein_distance(a, b, method="newton", options={**W1_NEWTON, "return_info": True})
    history = dt.BeckmannConvergenceHistory()
    history.append(increment=1.0, distance=float(distance))
    criteria = dt.BeckmannConvergenceCriteria(num_iter=10, tol_distance=1e-3)
    solver = dt.BeckmannNewtonSolver(dt.Grid((16, 16), 1.0 / 16), None, dict(W1_NEWTON))
    return {"distance": distance, "flux": info["flux"], "solver": solver(a, b),
            "problem": isinstance(solver, dt.BeckmannProblem), "history": str(sorted(history.as_dict())),
            "criteria": criteria.num_iter}


@case("BeckmannBregmanSolver", "BeckmannGproxPGHDSolver", "wasserstein_distance_3d", layer="analysis",
      rtol=1e-4, atol=1e-6)
def wasserstein_split(dev, seed):
    src, dst = two_blocks()
    meta = {"width": 1.0, "height": 1.0}
    a, b = scalar(src, dev, **meta), scalar(dst, dev, **meta)
    grid = dt.Grid((16, 16), 1.0 / 16)
    options = {"num_iter": 20, "tol_distance": 0.0, "tol_increment": 0.0}
    vol_a = np.zeros((6, 6, 6), np.float32)
    vol_a[1:3, 1:3, 1:3] = 1
    vol_b = np.roll(vol_a, 2, axis=0)
    va = scalar(vol_a / vol_a.sum(), dev, dim=3, dimensions=[1.0, 1.0, 1.0])
    vb = scalar(vol_b / vol_b.sum(), dev, dim=3, dimensions=[1.0, 1.0, 1.0])
    return {"bregman": dt.BeckmannBregmanSolver(grid, None, dict(options))(a, b),
            "gprox": dt.BeckmannGproxPGHDSolver(grid, None, dict(options))(a, b),
            "3d": dt.wasserstein_distance_3d(va, vb, method="newton", options={"num_iter": 10})}


@case("BeckmannLinearSolverFactory", "BeckmannLinearSolver", "BeckmannDirectSolver", "BeckmannCGSolver",
      "BeckmannAMGSolver", "BeckmannKSPSolver", "BeckmannKSPFieldSplitSolver", layer="analysis", default=False,
      rtol=1e-4, atol=1e-5)
def beckmann_linear_solvers(dev, seed):
    rng = rng_of(seed)
    shape = (12, 10)
    trans = [torch.as_tensor(np.exp(np.log(20.0) * rng.uniform(0, 1, s)).astype(np.float32), device=dev)
             for s in ((11, 10), (12, 9))]
    rhs = rng.standard_normal(shape).astype(np.float32)
    rhs = torch.as_tensor(rhs - rhs.mean(), device=dev)
    out = {}
    for kind in ("direct", "cg", "amg", "ksp", "ksp-fieldsplit"):
        options = {"rtol": 1e-7, "petsc_options": {"ksp_rtol": 1e-7}} if kind.startswith("ksp") else {"rtol": 1e-7}
        solver = dt.BeckmannLinearSolverFactory.create(kind, shape, options)
        solver.setup(tuple(trans))
        out[kind] = solver.solve(rhs)
        out[kind + " class"] = type(solver).__name__
    out["base"] = issubclass(dt.BeckmannCGSolver, dt.BeckmannLinearSolver)
    return out


@case("Grid", "generate_grid", "FVDivergence", "FVMass", "FVFullFaceReconstruction", "FVTangentialFaceReconstruction",
      "cell_to_face_average", "face_to_cell", layer="analysis", default=False)
def finite_volumes(dev, seed):
    rng = rng_of(seed)
    grid = dt.Grid((8, 10), 0.5)
    flat = torch.as_tensor(rng.standard_normal(grid.num_faces).astype(np.float32), device=dev)
    cell = torch.as_tensor(rng.random((8, 10)).astype(np.float32), device=dev)
    image = dt.ScalarImage(torch.zeros((8, 10), device=dev), width=1.0, height=0.8)
    return {"cells": dt.face_to_cell(grid, flat), "full": dt.FVFullFaceReconstruction(grid)(flat),
            "tangential": dt.FVTangentialFaceReconstruction(grid)(flat),
            "average": dt.cell_to_face_average(grid, cell, "harmonic"),
            "div": dt.FVDivergence(grid).mat.toarray(), "mass": dt.FVMass(grid, "faces").mat.toarray(),
            "generated": dt.generate_grid(image).shape}


@case("EMD", layer="analysis", needs="cv2", where="host",
      cite="darsia_tpu/measure/emd.py:17-31 (cv2.EMD on host signatures)")
def emd(dev, seed):
    src, dst = two_blocks(8)
    meta = {"width": 1.0, "height": 1.0}
    a = dt.ScalarImage(torch.as_tensor(src, device=dev or "cpu"), **meta)
    b = dt.ScalarImage(torch.as_tensor(dst, device=dev or "cpu"), **meta)
    return {"emd": dt.EMD()(a, b), "matrix": dt.EMD().distance_matrix([a, b, a])}


def vtk_numbers(path) -> np.ndarray:
    """The numbers a legacy VTK file holds (header and data), float64."""
    import re

    text = Path(path).read_bytes().decode("latin-1")
    return np.array(re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", text), dtype=float)


@case("wasserstein_distance_to_vtk", layer="analysis", where="host", rtol=1e-4, atol=1e-6,
      cite="darsia_tpu/measure/wasserstein.py:117 (a host file write)", default=False)
def wasserstein_vtk(dev, seed):
    src, dst = two_blocks(8)
    meta = {"width": 1.0, "height": 1.0}
    a = dt.ScalarImage(torch.as_tensor(src, device=dev or "cpu"), **meta)
    b = dt.ScalarImage(torch.as_tensor(dst, device=dev or "cpu"), **meta)
    _, info = dt.wasserstein_distance(a, b, options={"num_iter": 5, "return_info": True})
    with scratch() as folder:
        dt.wasserstein_distance_to_vtk(folder / "w1", info)
        return {"numbers": [vtk_numbers(p) for p in sorted(folder.iterdir())]}


# ================================================================ presets and workflows


def layered_baseline(seed, shape=(40, 56), layers=3):
    """(baseline RGB float32, labels int64): wavy horizontal layers."""
    rng = rng_of(seed)
    rows, cols = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    labels = np.zeros(shape, np.int64)
    for k in range(1, layers):
        labels += rows >= k * shape[0] / layers + 2.0 * np.sin(2 * np.pi * cols / 37.0 + k)
    base = (0.4 + 0.1 * labels[..., None] + rng.normal(0, 0.005, shape + (3,))).astype(np.float32)
    return base, labels


def layer_paths(layers, seed=9):
    rng = rng_of(seed)
    interps, functions = {}, {}
    for label in range(layers):
        direction = rng.choice([-1.0, 1.0], 3) * rng.uniform(0.3, 1.0, 3)
        relative = np.cumsum(np.vstack([np.zeros(3), rng.uniform(0.02, 0.06, (4, 1)) * direction]), axis=0)
        path = dt.ColorPath(relative_colors=list(relative), base_color=rng.uniform(0.2, 0.6, 3))
        interps[label] = dt.ColorPathInterpolation(path, dt.ColorMode.RELATIVE, values=path.equidistant_distances)
        functions[label] = dt.PWTransformation(supports=[0.0, 0.5, 1.0], values=[0.0, 0.4, 1.0])
    return interps, functions


def mass_chain(dev, seed, layers=3):
    base_np, labels_np = layered_baseline(seed, layers=layers)
    meta = {"width": 1.4, "height": 1.0}
    baseline = optical(base_np, dev, **meta)
    labels = dt.Image(on(labels_np, dev), scalar=True, **kw(dev), **meta)
    interps, functions = layer_paths(layers)
    geometry = dt.ExtrudedPorousGeometry(np.full((40, 56), 0.44), np.full((40, 56), 0.02), **baseline.shape_metadata())
    adapter = dt.ExpertKnowledgeAdapter(saturation_g_rois={"gas": np.array([[0.0, 0.6], [0.7, 0.0]])})
    chain = dt.HeterogeneousColorToMassAnalysis(
        baseline, labels, dt.ColorMode.RELATIVE, interps, functions, dt.SimpleFlash(0.05, 0.5, 0.5, 1.0),
        dt.CO2MassAnalysis(baseline, 1.01, 23.0), geometry, expert_knowledge_adapter=adapter)
    probe = base_np.copy()
    probe[12:30, 10:40] += np.array([0.08, -0.05, 0.06], np.float32)
    return chain, optical(np.clip(probe, 0, 1), dev, **meta), geometry


@case("HeterogeneousColorToMassAnalysis", "HeterogeneousColorAnalysis", "SimpleFlash", "CO2MassAnalysis",
      "ExpertKnowledgeAdapter", "SimpleRunAnalysis", "MultiphaseTimeSeriesAnalysis", layer="presets",
      rtol=1e-4, atol=1e-6)
def colour_to_mass(dev, seed):
    chain, probe, geometry = mass_chain(dev, seed)
    result = chain(probe)
    run = dt.SimpleRunAnalysis(geometry)
    run.append(result, name="probe")
    series = dt.MultiphaseTimeSeriesAnalysis(geometry)
    result.time = 1.0
    series.track(result)
    return {"mass": result.mass, "mass_g": result.mass_g, "s_g": result.saturation_g, "c_aq": result.concentration_aq,
            "integrated": str(sorted(run.integrated_mass(result))), "series": series.data.mass,
            "color": isinstance(chain.color_analysis, dt.HeterogeneousColorAnalysis)}


@case("Flash", "AdvancedFlash", "AdvancedCO2MassAnalysis", "full_like", layer="presets", rtol=1e-5, atol=1e-7)
def flashes(dev, seed):
    rng = rng_of(seed)
    meta = {"width": 1.4, "height": 1.0}
    c_g = scalar(rng.uniform(0, 1, (40, 56)).astype(np.float32), dev, **meta)
    c_aq = scalar(rng.uniform(0, 1, (40, 56)).astype(np.float32), dev, **meta)
    baseline = optical(smooth(rng, (40, 56), 3), dev, **meta)
    mass = dt.CO2MassAnalysis(baseline, 1.01, 23.0)
    ident = type("Identity", (), {"__call__": lambda self, img: img})()
    advanced = dt.AdvancedCO2MassAnalysis(ident, ident, None, dt.Flash(), mass)
    return {"flash": dt.Flash(s_g_max=0.8)(c_g, c_aq), "advanced_flash": dt.AdvancedFlash(0.9, 0.1)(c_g, c_aq),
            "advanced": advanced(c_g), "full": dt.full_like(c_g, np.full((40, 56), 2.0, np.float32)), "mass": mass(c_g, c_aq)}


@case("co2_gas_density", "co2_solubility", "water_density", layer="presets", where="host",
      cite="darsia_tpu/multiphase/mass_analysis.py:46-80 (numpy)")
def densities(dev, seed):
    p, t = np.array([1.0, 1.2]), np.array([20.0, 23.0])
    return {"gas": dt.co2_gas_density(p, t), "solubility": dt.co2_solubility(p, t), "water": dt.water_density(t)}


def npz_photo(path, arr, **meta):
    dt.OpticalImage(torch.from_numpy(np.asarray(arr, np.float32)), color_space="RGB",
                    **({"width": 2.0, "height": 1.0} | meta)).save(path)
    return path


FF_COMMON = {
    "diff option": "absolute", "restoration -> model": True, "restoration resize": 0.5,
    "restoration method": "chambolle", "restoration weight": 0.05, "restoration max_num_iter": 10,
    "prior remove small objects size": 5, "prior fill holes size": 5, "prior resize": 0.5,
    "prior method": "chambolle", "prior weight": 0.05, "prior max_num_iter": 10,
    "posterior criterion": "value", "posterior threshold": 0.02,
}


def fluidflower_scene(folder, seed):
    rng = rng_of(seed)
    base = np.full((40, 80, 3), 0.55) + rng.normal(0, 0.005, (40, 80, 3))
    img = base.copy()
    img[12:34, 16:56] += [-0.25, -0.1, 0.2]
    img[20:30, 28:44] += [-0.2, -0.15, 0.25]
    npz_photo(folder / "base.npz", base)
    npz_photo(folder / "img.npz", np.clip(img, 0, 1))
    config = {"physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
              "co2": dict(FF_COMMON, color="negative-key", cleaning_filter=str(folder / "c1.npy"),
                          **{"prior threshold value": 0.15}),
              "co2(g)": dict(FF_COMMON, color="blue", cleaning_filter=str(folder / "c2.npy"),
                             **{"prior threshold value": 0.3}),
              "tracer": {"color": "gray", "diff option": "absolute", "restoration resize": 0.5,
                         "restoration method": "chambolle", "restoration weight": 0.05,
                         "restoration max_num_iter": 10, "model scaling": 3.0,
                         "cleaning_filter": str(folder / "tracer.npy")},
              "segmentation": {"labels_path": str(folder / "labels.npy"), "marker_points": [[10, 40], [30, 40]]}}
    (folder / "config.json").write_text(__import__("json").dumps(config))
    return folder / "config.json"


@case("FluidFlowerCO2Analysis", "CO2Analysis", "AnalysisBase", "ConcentrationAnalysisBase", layer="presets")
def fluidflower_co2(dev, seed):
    with scratch() as folder:
        config = fluidflower_scene(folder, seed)
        analysis = dt.FluidFlowerCO2Analysis(folder / "base.npz", config, folder / "results", **kw(dev))
        co2, gas = analysis.single_image_analysis(folder / "img.npz", write_segmentation_to_file=True)
        seg = np.load(folder / "results" / "npy_segmentation" / "img_segmentation.npy")
    return {"co2": co2, "gas": gas, "segmentation": seg}


@case("FluidFlowerTracerAnalysis", "TracerAnalysis", layer="presets", rtol=1e-5, atol=1e-6)
def fluidflower_tracer(dev, seed):
    with scratch() as folder:
        config = fluidflower_scene(folder, seed)
        analysis = dt.FluidFlowerTracerAnalysis(folder / "base.npz", config, folder / "results", **kw(dev))
        return {"tracer": analysis.single_image_analysis(folder / "img.npz")}


@case("FluidFlowerRig", layer="presets")
def fluidflower_rig(dev, seed):
    with scratch() as folder:
        arr = np.full((40, 80, 3), 0.3)
        arr[20:] = 0.7
        npz_photo(folder / "base.npz", arr)
        config = fluidflower_scene(folder, seed)
        npz_photo(folder / "base.npz", arr)
        rig = dt.FluidFlowerRig(folder / "base.npz", config, **kw(dev))
        return {"labels": rig.labels, "mask": rig._labels_to_mask([int(rig.labels[5, 5])])}


def checker_photo(folder, seed, shape=(120, 200), swatch=8, name="base.npz", shift=(0, 0)):
    frame, _ = checker_frame(seed, shape, swatch)
    frame = np.roll(frame, shift, axis=(0, 1))
    dt.OpticalImage(torch.from_numpy(frame), width=0.92, height=0.55).save(folder / name)
    return folder / name


@case("SimpleFluidFlower", layer="presets", warp=True, k1=18)
def simple_fluidflower(dev, seed):
    with scratch() as folder:
        base = checker_photo(folder, seed)
        probe = checker_photo(folder, seed, name="probe.npz", shift=(1, 2))
        rig = dt.SimpleFluidFlower(base, extra_active_corrections=[], **kw(dev),
                                   active_corrections=["type", "drift", "curvature", "dynamic-illumination", "color"])
        curvature = {"crop": {"pts_src": [[3, 4], [116, 3], [117, 195], [4, 197]], "width": 0.92, "height": 0.55},
                     "bulge": {"horizontal_bulge": 1e-6, "vertical_bulge": 2e-6}}
        samples = [(slice(60, 80), slice(20, 40)), (slice(90, 110), slice(100, 120))]
        rig.setup(specs={"width": 0.92, "height": 0.55}, curvature_options={"config": curvature},
                  dynamic_illumination_options={"samples": samples})
        names = [type(c).__name__ for c in rig.corrections]
        return {"names": names, "read": rig.read_image(probe), "baseline": rig.baseline}


@case("ImagingProtocol", "ImagingProtocolOld", "InjectionProtocol", "PressureTemperatureProtocol",
      "ProtocolledExperiment", "find_images_for_datetimes", "Experiment", layer="presets", where="host",
      cite="darsia_tpu/experiment/protocols.py:98-296, darsia_tpu/experiment/events.py:14, darsia_tpu/experiment/experiment.py:33-63 (CSV tables and datetimes)")
def protocols(dev, seed):
    from datetime import datetime

    with scratch() as folder:
        photos = folder / "photos"
        photos.mkdir()
        for k in range(4):
            (photos / f"img_{k:05d}.npz").write_bytes(b"")
        (folder / "imaging.csv").write_text(
            "image_id,datetime\n" + "".join(f"{k},2024-03-01T09:{10 * k:02d}:00\n" for k in range(4)))
        (folder / "injection.csv").write_text(
            "id,start,end,rate_kg_s\n0,2024-03-01T09:00:00,2024-03-01T09:30:00,1e-6\n")
        (folder / "pt.csv").write_text("datetime,pressure_bar,temperature_celsius\n"
                                       "2024-03-01T09:00:00,1.01,23.0\n2024-03-01T10:00:00,1.02,23.5\n")
        imaging = dt.ImagingProtocol(folder / "imaging.csv", pad=5)
        injection = dt.InjectionProtocol(folder / "injection.csv")
        pt = dt.PressureTemperatureProtocol(folder / "pt.csv")
        data = sorted(photos.glob("*.npz"))
        experiment = dt.ProtocolledExperiment(data, folder / "imaging.csv", folder / "injection.csv", folder / "pt.csv")
        when = [datetime(2024, 3, 1, 9, 21)]
        found = dt.find_images_for_datetimes(photos, imaging, when)
        old = dt.ImagingProtocolOld(pad=5)

        class Run(dt.Experiment):
            atmospheric_pressure, temperature = 1.01, 23.0
            injection_start, injection_end = datetime(2024, 3, 1, 9), datetime(2024, 3, 1, 10)

        return {"hours": [experiment.time_since_start(experiment.get_datetime(p)) for p in data], "found": [p.name for p in found],
                "mass": injection.injected_mass(datetime(2024, 3, 1, 9, 15)),
                "state": str(pt.get_state(datetime(2024, 3, 1, 9, 30))), "old": old.pad,
                "run": Run().hours_since_start(datetime(2024, 3, 1, 9, 45))}


def rig_assets(root, seed, shape=(96, 128), px=8, at=(6, 72)):
    """A rig's TOML config at ``shape`` (tests/test_torch_rig.py's assets):
    three photographs with a painted checker, a sketch, depths, facies and
    protocols."""
    meta = {"width": 1.4, "height": 1.05}
    H, W = shape
    (root / "images").mkdir()
    swatches = dt.ColorCheckerAfter2014().swatches_rgb
    for i, shift in enumerate([(0, 0), (1, 2), (2, -1)]):
        # A smooth scene (the two-pass gate's kind of image) under a gradient of light.
        frame = smooth(rng_of(seed), (H, W), 3, 0.3, 0.6, noise=0.0) * (0.85 + 0.3 * np.arange(W) / W)[None, :, None]
        frame[at[0]:at[0] + 4 * px, at[1]:at[1] + 6 * px] = np.kron(swatches, np.ones((px, px, 1)))
        if i:
            yy, xx = np.mgrid[0:H, 0:W]
            frame[((yy - 62) / 16) ** 2 + ((xx - 40) / 26) ** 2 < 1] *= np.array([0.6, 0.9, 1.2])
        u8 = np.roll((np.clip(frame, 0, 1) * 255).astype(np.uint8), shift, axis=(0, 1))
        dt.OpticalImage(torch.from_numpy(u8), **meta).save(root / "images" / f"img_{i:05d}.npz")
    sketch = np.zeros((H, W, 3), np.float32)
    sketch[:30], sketch[30:64], sketch[64:] = [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]
    dt.OpticalImage(torch.from_numpy(sketch), **meta).save(root / "sketch.npz")
    rng = rng_of(3)
    x, y = rng.uniform(0, 1.4, 20), rng.uniform(0, 1.05, 20)
    depth = 0.02 + 0.004 * np.sin(2 * x) * np.cos(3 * y)
    (root / "depth.csv").write_text("x,y,mean\n" + "".join(f"{a},{b},{c}\n" for a, b, c in zip(x, y, depth)))
    (root / "facies.csv").write_text("id,porosity,permeability\n0,0.44,2e-10\n1,0.36,9e-11\n2,0.40,1e-10\n")
    (root / "imaging.csv").write_text(
        "path,image_id,datetime\n" + "".join(f"img_{i:05d}.npz,{i},2024-03-01 {9 + i:02d}:00:00\n" for i in range(3)))
    (root / "injection.csv").write_text("id,location_x,location_y,start,end,rate_kg/s\n"
                                        "1,0.5,0.3,2024-03-01 09:30:00,2024-03-01 12:00:00,1e-6\n")
    (root / "pressure_temperature.csv").write_text("datetime,pressure_bar,temperature_celsius\n"
                                                   "2024-03-01 09:00:00,1.013,20.0\n2024-03-01 12:00:00,1.02,21.5\n")
    config = root / "config.toml"
    config.write_text(f"""
[data]
folder = "{root / 'images'}"
baseline = "img_00000.npz"
results = "{root / 'results'}"

[rig]
width = 1.4
height = 1.05
dim = 2
resolution = [{H}, {W}]

[depth]
measurements = "{root / 'depth.csv'}"

[labeling]
colored_image = "{root / 'sketch.npz'}"

[facies]
props = "{root / 'facies.csv'}"

[protocols]
imaging = "{root / 'imaging.csv'}"
injection = "{root / 'injection.csv'}"
pressure_temperature = "{root / 'pressure_temperature.csv'}"

[image_porosity]
mode = "from_image"
tol = 0.2
sample_width = 12
num_clusters = 3

[corrections.drift]
colorchecker = "upper_right"

[corrections.color]
colorchecker = "upper_right"

[corrections.curvature.config.crop]
pts_src = [[2, 3], [93, 2], [94, 124], [3, 126]]
width = 1.4
height = 1.05

[corrections.curvature.config.bulge]
horizontal_bulge = 1e-6
vertical_bulge = 2e-6
""")
    return config


@case("Rig", "FluidFlowerConfig", "FaciesProps", "ColorEmbeddingRuntime", "ColorChannelEmbedding",
      "ColorRangeEmbedding", "ColorPathEmbedding", "ColorEmbeddingTransform", "resolve_mode_image",
      layer="presets", warp=True, k1=22)
def rig_from_toml(dev, seed):
    from darsia_tpu_torch.presets.workflows import setup

    with scratch() as root:
        path = rig_assets(root, seed)
        setup.setup_depth_map(path, **kw(dev))
        setup.segment_colored_image(path, **kw(dev))
        rig = setup.setup_rig(dt.Rig, path, **kw(dev))
        config = dt.FluidFlowerConfig(path)
        image = rig.read_image(root / "images" / "img_00001.npz")
        raw = dt.imread(root / "images" / "img_00001.npz", **kw(dev))
        embedding = dt.ColorChannelEmbedding("red", dt.ColorMode.RELATIVE, dt.ColorEmbeddingBasis.LABELS,
                                             color_space="RGB", channel="r")
        runtime = dt.ColorEmbeddingRuntime(rig, **kw(dev))
        red = embedding.to_scalar_image(image, runtime)
        # Bounds clear of every pixel's hue (by 0.15 degrees) and saturation
        # (by 4e-5): the photograph's uint8 colours give hues at exact
        # values (240.0 among them) that a last-bit difference of the
        # conversion would move across a bound.
        hue = dt.ColorRangeEmbedding("hue", dt.ColorMode.ABSOLUTE, dt.ColorEmbeddingBasis.GLOBAL, root,
                                     color_space="HSV", ranges=[[181.7, 257.3], [0.113, None], [None, None]])
        path = dt.ColorPath(colors=[np.zeros(3), np.array([0.1, 0.05, -0.05]), np.array([0.2, 0.0, 0.1])])
        paths = dt.ColorPathEmbedding("co2", dt.ColorMode.RELATIVE, dt.ColorEmbeddingBasis.LABELS, root)
        dt.LabelColorPathMap({label: path for label in range(3)}).save(paths.color_paths_folder)
        transform = paths.canonical_transform(runtime)
        facies = dt.FaciesProps.load(rig.facies, root / "facies.csv")
        # rig.image_porosity is left out: its k-means classification of the
        # two-pass-warped baseline flips 29% of the pixels against that of
        # the gather-warped one (the card's path emulated on the CPU); the
        # porosity_and_tracer case holds PorosityAnalysis on unwarped data.
        return {"corrections": [type(c).__name__ for c in rig.corrections], "labels": rig.labels,
                "depth": rig.depth, "baseline": rig.baseline, "read": image,
                "red": red, "mode": dt.resolve_mode_image("red", image, scalar_products={"red": red}),
                "hue": hue.to_scalar_image(raw, runtime), "path": transform(image),
                "transform": isinstance(transform, dt.ColorEmbeddingTransform),
                "facies": facies.porosity, "rig_width": config.rig.width}


@case("parse_color_mode", "validate_mode_syntax", "mode_requires_color_to_mass", layer="presets", where="host",
      cite="darsia_tpu/presets/workflows/mode_resolution.py:58-92 (string parsing)")
def mode_strings(dev, seed):
    out = {}
    for mode in ("mass", "rescaled_mass", "saturation_g", "concentration_aq"):
        dt.validate_mode_syntax(mode)
        out[mode] = [dt.mode_requires_color_to_mass(mode), repr(dt.parse_color_mode(mode))]
    return out


@case("MultiFluidFlowerConfig", "FluidFlowerCO2Meta", layer="presets", where="host",
      cite="darsia_tpu/presets/workflows/config/multi_fluidflower_config.py:101, darsia_tpu/multiphase/fluidflower_co2_meta.py:16 (TOML and JSON)")
def config_files(dev, seed):
    import json

    with scratch() as root:
        path = rig_assets(root, seed, shape=(24, 32), px=2, at=(2, 18))
        (root / "results").mkdir()
        multi = root / "multi.toml"
        multi.write_text(f'[data]\nresults = "{root / "results"}"\n\n[run.a]\nconfig = "{path.name}"\n\n'
                         f'[run.b]\nconfig = "{path.name}"\n\n[wasserstein]\nruns = ["a", "b"]\ntimes = [1.0]\n')
        config = dt.MultiFluidFlowerConfig(multi, require_results=True)
        (root / "jpg").mkdir()
        for k in range(2):
            (root / "jpg" / f"img_{k}.JPG").write_bytes(b"")
        meta = {"data": {"folder": str(root / "jpg"), "baseline": "img_0.JPG", "pad": 5},
                "common": {"folder": str(root), "labels": "labels.npy"},
                "results": {"folder": str(root / "results"), "fluidflower": "ff"}}
        (root / "meta.json").write_text(json.dumps(meta))
        co2_meta = dt.FluidFlowerCO2Meta(root / "meta.json")
        return {"runs": list(config.runs.config), "baseline": Path(co2_meta.baseline).name,
                "labels": Path(co2_meta.labels).name}


@case("MultichromaticTracerAnalysis", "PorosityAnalysis", "patched_porosity_analysis", layer="presets",
      rtol=1e-4, atol=1e-5)
def porosity_and_tracer(dev, seed):
    rng = rng_of(seed)
    meta = {"width": 1.5, "height": 1.0}
    base = optical(smooth(rng, (48, 64), 3, 0.2, 0.6), dev, **meta)
    labels = dt.Image(on(stripe_labels((48, 64), 2), dev), scalar=True, **kw(dev), **meta)
    porosity = dt.PorosityAnalysis(base, labels=labels, num_clusters=3, sample_width=12)
    patched = dt.patched_porosity_analysis(base, labels=labels, num_clusters=3, sample_width=12)
    tracer = dt.MultichromaticTracerAnalysis(base, labels=labels)
    colors = [rng.uniform(0, 0.3, (4, 3)) for _ in range(2)]
    tracer.calibrate(colors, [np.linspace(0, 1, 4) for _ in range(2)])
    probe = optical(smooth(rng, (48, 64), 3, 0.2, 0.6), dev, **meta)
    return {"porosity": porosity(base), "patched": patched, "tracer": tracer(probe)}


@case("benchmark_binary_cleaning_preset", "benchmark_concentration_analysis_preset", layer="presets")
def benchmark_presets(dev, seed):
    base_np, probe_np = plume_frames(seed)
    meta = {"width": 1.5, "height": 1.0}
    base, probe = optical(base_np, dev, **meta), optical(probe_np, dev, **meta)
    options = dict(FF_COMMON, color="gray", **{"prior threshold value": 0.05})
    cleaning = dt.benchmark_binary_cleaning_preset(base, options)
    analysis = dt.benchmark_concentration_analysis_preset(base, None, options)
    return {"analysis": analysis(probe), "cleaning": cleaning(on(probe_np[..., 0] < 0.4, dev))}


@case("TransformationCalibrationSession", "calibrate_transformations", "HeterogeneousCalibrationSession",
      layer="presets", rtol=1e-4, atol=1e-9)
def calibration_sessions(dev, seed):
    H, W, times = 8, 10, [0.5, 1.0, 1.5]
    geometry = dt.Geometry(space_dim=2, num_voxels=(H, W), dimensions=[1, 1])
    tf_g = dt.PWTransformation(supports=[0.0, 1.0], values=[0.0, 1.0])
    tf_aq = dt.PWTransformation(supports=[0.0, 1.0], values=[0.0, 1.0])
    with scratch() as root:
        paths = [root / f"img_{i}.npz" for i in range(len(times))]
        signals = {}
        for k, (p, t) in enumerate(zip(paths, times)):
            signal = np.full((H, W), 0.5, np.float32)
            signal[k:k + 3, 2:7] = 0.75
            signals[p] = (on(signal, dev), t)

        def from_pre(pre):
            signal, t = pre
            mass = dt.ScalarImage(tf_g(signal) * t, width=1.0, height=1.0)
            zero = dt.ScalarImage(torch.zeros_like(mass.img), width=1.0, height=1.0)
            return dt.MassAnalysisResults(time=t, mass=mass, mass_g=mass, mass_aq=zero)

        common = (tf_g, tf_aq, paths, dt.MultiphaseTimeSeriesAnalysis(geometry))
        session = dt.TransformationCalibrationSession(
            *common, upper_time_limit=1.25, read_image=lambda p: p, pre_mass_analysis=lambda p: signals[p],
            mass_analysis_from_pre=from_pre, expected_mass=lambda t: t, log=root / "log")
        proposal = session.propose(values_g=[0.0, 2.0], values_aq=[0.0, 0.5])
        # Nelder-Mead turns last-bit differences of the masses into another
        # simplex path (0.125 apart after 5 iterations, card against CPU):
        # each device's calibration is held to lower the error, not to the
        # other's values.
        dt.calibrate_transformations(*common, upper_time_limit=1.25, read_image=lambda p: p,
                                     pre_mass_analysis=lambda p: signals[p], mass_analysis_from_pre=from_pre,
                                     log=root / "auto", expected_mass=lambda t: t, maxiter=5)
        chain, probe, _ = mass_chain(dev, seed)
        probe.time = 3600.0
        experiment = type("Run", (), {"injection_protocol": type("P", (), {
            "injected_mass": staticmethod(lambda time: 1e-4 * time)})()})()
        heterogeneous = dt.HeterogeneousCalibrationSession(chain, [probe], experiment)
        calibrated = session.propose()
        return {"proposal": sorted((k, np.asarray(v, float).tolist()) for k, v in proposal.items()),
                "improved": bool(calibrated["error"] <= proposal["error"]),
                "heterogeneous": sorted((k, np.asarray(v, float).tolist()) for k, v in heterogeneous.propose().items())}


@case("ContinuityBasedBalancingCalibrationMixin", "AbstractBalancingCalibration", "InjectionRateModelObjectiveMixin",
      "AbsoluteVolumeModelObjectiveMixin", "AbstractModelObjective", layer="analysis", rtol=1e-4, atol=1e-7)
def calibration_mixins(dev, seed):
    class Balanced(dt.ConcentrationAnalysis, dt.ContinuityBasedBalancingCalibrationMixin):
        pass

    class InjectionRate(dt.ConcentrationAnalysis, dt.InjectionRateModelObjectiveMixin):
        pass

    class AbsoluteVolume(dt.ConcentrationAnalysis, dt.AbsoluteVolumeModelObjectiveMixin):
        pass

    labels = np.zeros((20, 20), dtype=np.int64)
    labels[:, 10:] = 1
    arr = np.zeros((20, 20, 3), np.float32)
    arr[:, :10, 0], arr[:, 10:, 0] = 0.2, 0.4
    balanced = Balanced(base=optical(np.zeros((20, 20, 3), np.float32), dev),
                        signal_reduction=dt.MonochromaticReduction(color="red"),
                        balancing=dt.HeterogeneousLinearModel(on(labels, dev), scaling=1.0, offset=0.0))
    balanced.calibrate_balancing([optical(arr, dev, time=1.0)], {"labels": on(labels, dev)})
    blobs = []
    for t in range(1, 4):
        blob = np.zeros((20, 20, 3), np.float32)
        blob[:, : 4 * t, 0] = 0.5
        blobs.append(optical(blob, dev, time=float(t)))
    out = {"balancing": np.asarray(balanced.balancing._scaling, float)}
    common = {"initial_guess": np.array([1.0]), "method": "Nelder-Mead", "maxiter": 40, "dofs": ["scaling"]}
    for name, cls, options in (
        ("rate", InjectionRate, {"injection_rate": 0.2, "regression_type": "linear",
                                 "geometry": dt.Geometry(space_dim=2, num_voxels=(20, 20), dimensions=[1, 1])}),
        ("volume", AbsoluteVolume, {"geometry": dt.Geometry(space_dim=2, num_voxels=(20, 20), dimensions=[1e-2, 1e-2]),
                                    "times": np.array([1.0, 2.0, 3.0]), "volumes": 0.3 * np.array([1.0, 2.0, 3.0]),
                                    "time_interval": [1.0, 3.0]}),
    ):
        analysis = cls(base=optical(np.zeros((20, 20, 3), np.float32), dev),
                       signal_reduction=dt.MonochromaticReduction(color="red"),
                       model=dt.ScalingModel(scaling=1.0), **{"restoration -> model": True})
        analysis.calibrate_model(blobs, options={**common, **options})
        out[name] = float(analysis.model._scaling)
    return out


# ================================================================ utils


@case("kmeans", layer="utils", where="host", cite="darsia_tpu/utils/kmeans.py:18 (numpy)")
def kmeans(dev, seed):
    data = np.concatenate([rng_of(seed).normal(c, 0.05, (40, 3)) for c in (0.2, 0.5, 0.8)]).astype(np.float32)
    labels, centers = dt.kmeans(data, 3, seed=seed)
    return {"labels": labels, "centers": centers}


@case("label_image", "group_labels", "reassign_labels", "make_consecutive", layer="utils", where="host",
      cite="darsia_tpu/utils/segmentation.py:250-315 (numpy labels)")
def label_utilities(dev, seed):
    sketch = np.zeros((24, 32, 3), np.float32)
    sketch[:8], sketch[8:16], sketch[16:] = [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]
    labels = dt.label_image(sketch)
    return {"labels": labels, "grouped": dt.group_labels(labels, [[0, 1]]),
            "reassigned": dt.reassign_labels(labels, {2: 5}), "consecutive": dt.make_consecutive(labels * 2)}


@case("label_image", layer="utils", default=False)
def label_image_of_an_image(dev, seed):
    # default=False: an Image's labels stay on its device (a numpy sketch: see label_utilities).
    sketch = np.zeros((24, 32, 3), np.float32)
    sketch[:8], sketch[8:16], sketch[16:] = [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]
    return {"labels": dt.label_image(dt.OpticalImage(torch.as_tensor(sketch, device=dev)))}


@case("segment", "scharr_edges", layer="utils")
def segmentation(dev, seed):
    sketch = np.zeros((48, 64, 3), np.float32)
    sketch[:16], sketch[16:32], sketch[32:] = [0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]
    sketch += rng_of(seed).normal(0, 0.01, sketch.shape).astype(np.float32)
    return {"labels": dt.segment(on(sketch, dev), markers_method="gradient_based", **kw(dev)),
            "edges": dt.scharr_edges(on(sketch[..., 0], dev), **kw(dev))}


@case("find_boundaries", "Masks", layer="utils", where="host",
      cite="darsia_tpu/utils/morphology.py:126, darsia_tpu/utils/masks.py:13 (numpy labels)")
def boundaries_and_masks(dev, seed):
    labels = stripe_labels((20, 24), 3)
    return {"outer": dt.find_boundaries(labels), "inner": dt.find_boundaries(labels, mode="inner"),
            "masks": [m for m in dt.Masks(labels)]}


@case("Masks", "roi_to_mask", layer="utils", default=False)
def masks_of_an_image(dev, seed):
    labels = dt.Image(torch.as_tensor(stripe_labels((20, 24), 3), device=dev), scalar=True, width=1.2, height=1.0)
    roi = np.array([[0.2, 0.8], [0.9, 0.1]])
    return {"masks": [(label, m) for m, label in dt.Masks(labels, return_label=True)],
            "roi": dt.roi_to_mask(roi, labels, mode="coordinates")}


@case("bounding_box", "bounding_box_inverse", "perimeter", "random_patches", layer="utils", where="host",
      cite="darsia_tpu/utils/box.py:14-90 (numpy)")
def boxes(dev, seed):
    voxels = rng_of(seed).integers(0, 40, (6, 2))
    box = dt.bounding_box(voxels, padding=2, max_size=[40, 40])
    return {"box": str(box), "inverse": dt.bounding_box_inverse(box), "perimeter": dt.perimeter(box),
            "patches": str(dt.random_patches((40, 56), 8, 3, rng=rng_of(seed)))}


@case("add_slices", "add_slice_pairs", "subtract_slices", "subtract_slice_pairs", "array_slice",
      "array_slice_argument", "array_product", layer="utils", where="host",
      cite="darsia_tpu/utils/slices.py:16-45, darsia_tpu/utils/arithmetics.py:10 (host)")
def slices_and_products(dev, seed):
    rng = rng_of(seed)
    a, b = slice(2, 10), slice(1, 4)
    arr = rng.random((6, 8, 3))
    return {"add": str(dt.add_slices(a, b)), "pairs": str(dt.add_slice_pairs((a, b), (b, a))),
            "sub": str(dt.subtract_slices(a, b)), "sub_pairs": str(dt.subtract_slice_pairs((a, b), (b, b))),
            "slice": dt.array_slice(arr, 1, 2, 6), "argument": str(dt.array_slice_argument(arr, 0, 1, 4)),
            "product": dt.array_product(arr, rng.random((6, 8)))}


@case("detect_value", "detect_color", layer="utils")
def detection(dev, seed):
    rng = rng_of(seed)
    rgb = rng.random((24, 32, 3)).astype(np.float32)
    rgb[5:8, 10:14] = [0.2, 0.4, 0.6]
    gray = rgb[..., 0].copy()
    gray[3, 4] = 0.5
    return {"value": dt.detect_value(on(gray, dev), 0.5, tolerance=1e-4, **kw(dev)),
            "color": dt.detect_color(on(rgb, dev), [0.2, 0.4, 0.6], tolerance=1e-3, **kw(dev))}


@case("orthogonal_colors", "detect_closest_point", layer="utils", where="host",
      cite="darsia_tpu/utils/detection.py:38,78 (numpy)")
def colour_geometry(dev, seed):
    pts = rng_of(seed).random((10, 2))
    return {"ortho": dt.orthogonal_colors(np.array([0.2, 0.4, 0.6])), "closest": dt.detect_closest_point(pts, [0.5, 0.5])}


@case("monochromatic_concentration_analysis", layer="utils", rtol=1e-5, atol=1e-6)
def monochromatic_concentration(dev, seed):
    rgb = smooth(rng_of(seed), (24, 32), 3)
    return {"conc": dt.monochromatic_concentration_analysis(optical(rgb, dev), np.array([0.2, 0.4, 0.6]))}


@case("FeatureDetection", "harris_corners", layer="utils", needs="cv2")
def features(dev, seed):
    rng = rng_of(seed)
    img = np.kron(rng.random((8, 12)), np.ones((8, 8))).astype(np.float32)
    rgb = np.repeat(img[..., None], 3, -1)
    detection = dt.FeatureDetection(max_features=40, **kw(dev))
    keypoints = detection.detect(on(rgb, dev))
    return {"harris": dt.harris_corners(on(img, dev), max_features=30, **kw(dev)), "keypoints": keypoints}


@case("hsv_spectrum", layer="utils", rtol=1e-5, atol=1e-6)
def hsv(dev, seed):
    rgb = smooth(rng_of(seed), (24, 32), 3)
    return {"spectrum": dt.hsv_spectrum(on(rgb, dev), bins=16, **kw(dev))}


@case("interpolate_measurements_2d", "interpolate_to_image", "interpolate_to_image_from_csv",
      layer="utils", rtol=1e-4, atol=1e-6)
def interpolations(dev, seed):
    rng = rng_of(seed)
    image = scalar(np.zeros((20, 28), np.float32), dev, width=1.4, height=1.0)
    x, y = rng.random(14) * 1.4, rng.random(14)
    data = (x, y, 1.0 + 0.3 * np.sin(2 * x) * np.cos(3 * y))
    with scratch() as folder:
        (folder / "m.csv").write_text("x,y,v\n" + "".join(f"{a},{b},{c}\n" for a, b, c in zip(*data)))
        from_csv = dt.interpolate_to_image_from_csv(folder / "m.csv", "v", image, method="quadratic")
    return {"tps": dt.interpolate_measurements_2d(data, image.coordinatesystem, **kw(dev)),
            "rbf": dt.interpolate_to_image(data, image), "cubic": dt.interpolate_to_image(data, image, "cubic"),
            "csv": from_csv}


@case("illumination_interpolation", "polynomial_interpolation", "LinearApproximation",
      "PolynomialApproximationSpace", "RadialPolynomialApproximationSpace", layer="utils", where="host",
      cite="darsia_tpu/utils/interpolation.py:111-150, darsia_tpu/utils/approximations.py:37-120 (numpy)", default=False)
def host_fits(dev, seed):
    rng = rng_of(seed)
    cs = dt.ScalarImage(torch.zeros((20, 28)), width=1.4, height=1.0).coordinatesystem
    x, y = rng.random(14) * 1.4, rng.random(14)
    data = (x, y, 1.0 / (0.5 + (x - 0.7) ** 2 + (y - 0.5) ** 2))
    approx = dt.LinearApproximation(dt.PolynomialApproximationSpace(2), 1)
    approx.fit(np.stack([x, y], 1), data[2][:, None])
    radial = dt.RadialPolynomialApproximationSpace(2, center=np.array([0.7, 0.5]))
    return {"illumination": dt.illumination_interpolation(data, cs), "poly": dt.polynomial_interpolation(data, cs),
            "approx": approx.evaluate(np.stack([x, y], 1)), "radial": np.stack(radial(np.stack([x, y], 1)))}


@case("extract_characteristic_data", layer="utils", where="host",
      cite="darsia_tpu/utils/extractcharacteristicdata.py:20 (numpy k-means of host patches)")
def characteristic_data(dev, seed):
    rgb = smooth(rng_of(seed), (24, 32), 3)
    return {"colors": dt.extract_characteristic_data(rgb, samples=[(slice(2, 12), slice(2, 12)),
                                                                  (slice(12, 22), slice(16, 30))], num_clusters=3)}


@case("convert_dtype", "timing_decorator", layer="utils", default=False)
def dtypes_and_timing(dev, seed):
    img = torch.as_tensor(rng_of(seed).random((8, 10)).astype(np.float32), device=dev)
    timed = dt.timing_decorator(lambda x: x * 2)
    return {"u8": dt.convert_dtype(img, np.uint8), "f64": dt.convert_dtype(img, torch.float64), "timed": timed(img)}


@case("to_vtk", layer="utils", default=False)
def vtk_export(dev, seed):
    rng = rng_of(seed)
    image = dt.ScalarImage(torch.as_tensor(rng.random((8, 10)).astype(np.float32), device=dev), width=1.0, height=0.8)
    with scratch() as folder:
        dt.to_vtk(folder / "a", [("scalar", image), ("tensor", torch.as_tensor(rng.random((8, 10)), device=dev))])
        return {"numbers": [vtk_numbers(p) for p in sorted(folder.iterdir())]}


@case("plot_contour_on_image", "plot_distribution_on_image", "plot_image_statistics", layer="utils",
      needs="matplotlib", default=False)
def plots(dev, seed):
    import matplotlib

    matplotlib.use("Agg")
    rng = rng_of(seed)
    image = dt.OpticalImage(torch.as_tensor(smooth(rng, (24, 32), 3), device=dev), width=1.2, height=0.9)
    mask = torch.as_tensor(blob_mask((24, 32), seed), device=dev)
    with scratch() as folder:
        dt.plot_contour_on_image(image, mask=[mask], path=folder / "c.png")
        dt.plot_distribution_on_image(image, torch.as_tensor(rng.random((24, 32)), device=dev), path=folder / "d.png")
        dt.plot_image_statistics(image, path=folder / "s.png")
        return {"files": sorted(p.name for p in folder.iterdir())}


def assistant_pair(dev, seed):
    rng = rng_of(seed)
    arr = smooth(rng, (60, 90), 3)
    arr[:30, :45] *= 0.5
    return dt.Image(on(arr, dev), **kw(dev), width=1.8, height=1.2, color_space="RGB")


@case("PointSelectionAssistant", "BoxSelectionAssistant", "RectangleSelectionAssistant", "SubregionAssistant",
      "RotationCorrectionAssistant", "CropAssistant", "BaseAssistant", layer="utils")
def selection_assistants(dev, seed):
    img = assistant_pair(dev, seed)
    rotation = dt.RotationCorrectionAssistant(img, points=[[30, 10], [33, 80]])()
    return {"points": dt.PointSelectionAssistant(img, points=[[10, 20], [30, 40]])(),
            "boxes": str(dt.BoxSelectionAssistant(img, width=10, points=[[30, 45], [2, 88]])()),
            "rect": str(dt.RectangleSelectionAssistant(img, corners=[[30, 50], [10.5, 20]])()),
            "sub": dt.SubregionAssistant(img, coordinates=[[0.2, 0.2], [1.0, 1.0]])(),
            "rotated": rotation[0](img), "crop": str(dt.CropAssistant(img, width=1.8, height=1.2,
                                                                      points=[[2, 3], [57, 2], [58, 87], [3, 88]])())}


@case("LabelsAssistant", "LabelsMaskSelectionAssistant", "LabelsMergeAssistant", "LabelsPickAssistant",
      "LabelsSegmentAssistant", "MonochromaticAssistant", layer="utils")
def labels_assistants(dev, seed):
    img = assistant_pair(dev, seed)
    assistant = dt.LabelsAssistant(background=img)
    labels = assistant.segment(marker_points=[[15, 20], [45, 70]])
    ids = torch.unique(labels.img)[:2].tolist()
    merged = dt.LabelsMergeAssistant(labels, img)(ids=ids)
    return {"labels": labels, "picked": dt.LabelsPickAssistant(labels, img)(ids=ids[1:]), "merged": merged,
            "mask": dt.LabelsMaskSelectionAssistant(merged)(points=[[15, 20]]),
            "segment": dt.LabelsSegmentAssistant(labels, img)(marker_points=[[15, 20], [45, 70]]),
            "gray": dt.MonochromaticAssistant(img, color="gray")()}


@case("LabelsAssistantMenu", layer="utils", needs="matplotlib", default=False)
def labels_menu(dev, seed):
    import matplotlib

    matplotlib.use("Agg")
    img = assistant_pair(dev or "cpu", seed)
    background = dt.Image(torch.zeros(60, 90, dtype=torch.bool, device=img.device), width=1.8, height=1.2, scalar=True)
    menu = dt.LabelsAssistantMenu(img, background=background, strict=False, block=False)
    return {"action": str(menu())}


# ================================================================ exemptions

#: Public names no case exercises, each with its category: (a) an abstract
#: base or mixin, covered through the named concrete subclass's case; (b)
#: an enum, a dataclass or a type alias with no tensor work; (c) needs
#: tkinter and a display.
EXEMPT = {
    "ApproximationSpace": ("a", "abstract basis; PolynomialApproximationSpace in host_fits"),
    "BaseBalance": ("a", "abstract balance; WhiteBalance and the others in balances"),
    "BaseKernel": ("a", "abstract kernel; GaussianKernel and LinearKernel in kernel_interpolation"),
    "BasePoint": ("a", "base of the point types; Coordinate, Voxel, ... in points"),
    "BaseTransformation": ("a", "abstract point map; AffineTransformation in point_maps"),
    "ColorEmbedding": ("a", "abstract embedding; ColorChannelEmbedding and the others in rig_from_toml"),
    "ContourSmoother": ("a", "abstract smoother; the four smoothers in contours"),
    "BeckmannLinearSolverType": ("b", "enum of linear solver names"),
    "ColorEmbeddingBasis": ("b", "enum of embedding bases"),
    "ColorMode": ("b", "enum of colour modes"),
    "ConvergenceStatus": ("b", "enum of solver statuses"),
    "Format": ("b", "enum of VTK formats"),
    "L1Mode": ("b", "enum of Beckmann L1 modes"),
    "MobilityMode": ("b", "enum of Beckmann mobility modes"),
    "ImagingInterval": ("b", "dataclass of an imaging interval"),
    "MassAnalysisResults": ("b", "dataclass of result maps (colour_to_mass returns one)"),
    "MultiphaseTimeSeriesData": ("b", "dataclass of mass lists"),
    "SimpleMassAnalysisResults": ("b", "dataclass of result maps"),
    "SimpleMultiphaseTimeSeriesData": ("b", "dataclass of mass lists"),
    "ThermodynamicState": ("b", "dataclass of a pressure and a temperature"),
    "ThresholdAnalysisResults": ("b", "dataclass of result masks"),
    "TimeSeriesData": ("b", "dataclass of times"),
    "TimeWindow": ("b", "dataclass of a time window"),
    "ColorCheckerPosition": ("b", "type alias of str"),
    "Contour": ("b", "type alias of numpy.ndarray"),
}


# ================================================================ the CPU tests


def default_call_fault(c: Case, seed: int = 0) -> Optional[str]:
    """What is wrong with the case's default call here, or None: a card
    case's default call goes to the card (without one it raises torch's or
    the port's CUDA error), a host case's runs."""
    if expects_import_error(c):
        try:
            run_case(c, None, seed)
        except ImportError as err:
            return None if c.needs in str(err) else f"ImportError not naming {c.needs}: {err}"
        return f"no ImportError naming {c.needs}"
    if c.where == "host" or torch.cuda.is_available():
        out = run_case(c, None, seed)
        missed = off_card(out) if c.where == "card" else []
        return f"the default call left {missed}" if missed else None
    try:
        run_case(c, None, seed)
    except (RuntimeError, AssertionError) as err:
        return None if "CUDA" in str(err) else f"{type(err).__name__} not naming CUDA: {err}"
    return "the default call ran without a card: its default is the CPU"


def cpu_tests(layer: str) -> tuple:
    """The two parametrised tests of a layer's cases, for its test file:
    each case runs on the CPU with finite outputs, bitwise equal when run
    again with the same seed (or raises the ImportError naming its absent
    library); and each default call goes where ``default_call_fault``
    says."""
    import pytest

    names = [c.name for c in CASES.values() if c.layer == layer]
    defaults = [c.name for c in CASES.values() if c.layer == layer and (c.default or c.where == "host")]

    @pytest.mark.parametrize("name", names)
    def test_case_runs_on_the_cpu_and_repeats(name):
        c = CASES[name]
        if expects_import_error(c):
            with pytest.raises(ImportError, match=c.needs):
                run_case(c, "cpu")
            return
        first, again = run_case(c, "cpu"), run_case(c, "cpu")
        assert not finite(first), f"non-finite outputs: {finite(first)}"
        assert not identical(first, again), f"a second run differs at {identical(first, again)}"
        if c.where == "card":
            assert all(dev == torch.device("cpu") for _, dev in devices_of(first)), devices_of(first)

    @pytest.mark.parametrize("name", defaults)
    def test_default_call_goes_to_the_card(name):
        fault = default_call_fault(CASES[name])
        assert fault is None, fault

    return test_case_runs_on_the_cpu_and_repeats, test_default_call_goes_to_the_card


# 20 Newton iterations over 4 shards, each CG solve to its tolerance: the
# pressures 2.9e-5 apart, an H100 against the CPU.
@case("wasserstein_distance", layer="analysis", rtol=1e-3, atol=1e-4)
def wasserstein_sharded(dev, seed):
    from darsia_tpu_torch.parallel import create_mesh

    src, dst = two_blocks()
    meta = {"width": 1.0, "height": 1.0}
    mesh = create_mesh((1,), ("space",)) if dev is None else create_mesh((4,), ("space",), devices=[dev] * 4)
    a, b = scalar(src, dev, **meta), scalar(dst, dev, **meta)
    distance, info = dt.wasserstein_distance(a, b, method="sharded_newton",
                                             options={"mesh": mesh, "num_iter": 20, "return_info": True})
    return {"distance": distance, "pressure": info["pressure"], "flux": info["flux"]}
