"""VTK export: ``to_vtk``, ``Image.to_vtk`` and ``wasserstein_distance_to_vtk``
write the JAX package's bytes.

The same seeded arrays (float32 and float64, with ``-0.0`` and values whose
float32 and float64 reprs differ) go through the JAX package's writer and
the port's, the port's given tensors, images or numpy arrays; the files
must be byte-equal.  Covered: scalar, vector (2 and 3 components) and tensor
fields, two shapes, a 3-D array (only its two leading axes span the grid in
both writers), integer data, and the info of a weighted 16x16 W1 solve by
each package, both writers fed the same arrays.  The port's parsed values
are also held exactly equal to the data.
"""

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.utils.formats import Format as JaxFormat
from darsia_tpu.utils.plotting import to_vtk as jax_to_vtk
from darsia_tpu_torch.utils.formats import Format
from darsia_tpu_torch.utils.plotting import to_vtk

torch.set_num_threads(1)

SHAPES = [(5, 7), (12, 9)]
DTYPES = [np.float32, np.float64]


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape)).astype(dtype)
    flat = a.reshape(-1)
    flat[:4] = [0.0, -0.0, 0.1, 1e16][: flat.size]
    return a


def _jax_fmt(fmt):
    return None if fmt is None else JaxFormat(fmt.value)


def _write_both(tmp_path, items, as_port=lambda a: torch.from_numpy(a)):
    """Bytes of the JAX writer on numpy arrays and of the port's on
    ``as_port(array)``; ``items`` are (name, array, Format or None)."""
    jax_items = [(n, a) if f is None else (n, a, _jax_fmt(f)) for n, a, f in items]
    port_items = [(n, as_port(a)) if f is None else (n, as_port(a), f) for n, a, f in items]
    jax_to_vtk(tmp_path / "jax.vtk", jax_items)
    to_vtk(tmp_path / "port", port_items)
    return (tmp_path / "jax.vtk").read_bytes(), (tmp_path / "port.vtk").read_bytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize(
    "fmt,channels",
    [(None, 0), (Format.SCALAR, 0), (Format.VECTOR, 2), (Format.VECTOR, 3), (Format.TENSOR, 4)],
)
def test_to_vtk_bytes_equal_jax(tmp_path, shape, dtype, fmt, channels):
    full = shape + ((channels,) if channels else ())
    items = [("field", _field(full, dtype, 1), fmt), ("other", _field(shape, dtype, 2), Format.SCALAR)]
    jax_bytes, port_bytes = _write_both(tmp_path, items)
    assert port_bytes == jax_bytes
    if fmt == Format.VECTOR:
        assert b"-0.0 " in port_bytes or b" -0.0\n" in port_bytes


@pytest.mark.parametrize("as_port", [np.asarray, lambda a: dt.Image(torch.from_numpy(a), device="cpu")])
def test_to_vtk_takes_arrays_and_images(tmp_path, as_port):
    items = [("v", _field((6, 4, 2), np.float32, 3), Format.VECTOR), ("s", _field((6, 4), np.float64, 4), None)]
    jax_bytes, port_bytes = _write_both(tmp_path, items, as_port)
    assert port_bytes == jax_bytes


def test_to_vtk_integer_and_3d_data(tmp_path):
    ints = np.arange(-10, 14, dtype=np.int32).reshape(4, 6)
    vec = np.arange(48, dtype=np.int64).reshape(4, 6, 2) - 20
    volume = _field((4, 6, 3), np.float32, 5)  # a 3-D array: its first slab only
    items = [("i", ints, None), ("v", vec, Format.VECTOR), ("vol", volume, Format.SCALAR)]
    jax_bytes, port_bytes = _write_both(tmp_path, items)
    assert port_bytes == jax_bytes


def _parse(text: str) -> dict:
    """Field name -> values of a legacy VTK file (vectors as rows)."""
    fields, lines, k = {}, text.splitlines(), 8
    n = int(lines[7].split()[1])
    while k < len(lines):
        head = lines[k].split()
        if head[0] == "SCALARS":
            fields[head[1]] = np.array(lines[k + 2 : k + 2 + n], dtype=np.float64)
            k += 2 + n
        else:
            rows = " ".join(lines[k + 1 : k + 1 + n]).split()
            fields[head[1]] = np.array(rows, dtype=np.float64).reshape(n, 3)
            k += 1 + n
    return fields


def test_image_to_vtk_bytes_equal_jax_and_values_exact(tmp_path):
    data = _field((9, 11), np.float32, 6)
    jax_image = da.ScalarImage(data, width=1.1, height=0.9)
    port_image = dt.ScalarImage(torch.from_numpy(data), width=1.1, height=0.9)
    jax_image.to_vtk(tmp_path / "jax", name="conc")
    port_image.to_vtk(tmp_path / "port", name="conc")
    text = (tmp_path / "port.vtk").read_text()
    assert text == (tmp_path / "jax.vtk").read_text()
    values = _parse(text)["conc"]
    assert np.array_equal(values.astype(np.float32), data[::-1].reshape(-1))
    assert np.array_equal(values, data[::-1].reshape(-1).astype(np.float64))


@pytest.fixture(scope="module")
def w1_infos():
    n = 16
    src, dst = np.zeros((n, n)), np.zeros((n, n))
    src[3:8, 3:8], dst[2:5, 10:14], dst[9:14, 6:9] = 1.0, 1.0, 1.0
    src = (src / src.sum() * n**2).astype(np.float32)
    dst = (dst / dst.sum() * n**2).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    weight = (2.0 + np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy)).astype(np.float32)
    options = {"L": 1e9, "num_iter": 50, "tol_distance": 1e-4, "return_info": True}
    meta = {"width": 1, "height": 1, "scalar": True}
    _, jax_info = da.wasserstein_distance(
        da.Image(src, **meta), da.Image(dst, **meta), method="newton",
        weight=da.ScalarImage(weight, width=1, height=1), options=options,
    )
    _, port_info = dt.wasserstein_distance(
        dt.Image(src, device="cpu", **meta), dt.Image(dst, device="cpu", **meta),
        method="newton", weight=weight, options=options,
    )
    return jax_info, port_info


KEYS = ["src", "dst", "mass_diff", "flux", "weighted_flux", "pressure", "transport_density", "weight", "weight_inv"]


def test_w1_infos_hold_every_exported_key(w1_infos):
    jax_info, port_info = w1_infos
    assert all(key in jax_info and key in port_info for key in KEYS)


@pytest.mark.parametrize("owner", ["jax", "port"])
def test_wasserstein_distance_to_vtk_bytes_equal_jax(tmp_path, w1_infos, owner):
    info = w1_infos[owner == "port"]
    host = {k: np.asarray(v.img if hasattr(v, "img") else v) for k, v in info.items() if k in KEYS}
    da.wasserstein_distance_to_vtk(tmp_path / "jax", host)
    dt.wasserstein_distance_to_vtk(tmp_path / "port", info if owner == "port" else host)
    text = (tmp_path / "port.vtk").read_text()
    assert (tmp_path / "port.vtk").read_bytes() == (tmp_path / "jax.vtk").read_bytes()
    fields = _parse(text)
    assert list(fields) == KEYS
    flux = host["flux"][::-1].reshape(-1, 2).astype(np.float64)
    assert np.array_equal(fields["flux"], np.stack([flux[:, 1], -flux[:, 0], np.zeros(len(flux))], -1))
    assert np.array_equal(fields["pressure"], host["pressure"][::-1].reshape(-1).astype(np.float64))
