"""Export and plot helpers: a legacy-ASCII VTK writer and the W1 overlay.

Counterpart of :mod:`darsia_tpu.utils.plotting`.  :func:`to_vtk` takes
tensors on any device, images or numpy arrays, copies each array to the
host once and formats it column-wise (one ``join`` per array, no write per
voxel); the file is byte for byte the JAX package's.  The plot draws with
matplotlib, imported when called.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..image.image import as_numpy
from .formats import Format
from .optional import optional_module

__all__ = ["to_vtk", "plot_2d_wasserstein_distance"]


def _host(array) -> np.ndarray:
    """One host copy of a tensor, an image's data or an array-like."""
    return as_numpy(array.img if hasattr(array, "img") else array)


def _text(values: np.ndarray) -> list:
    """Each value as the JAX writer formats it: ``float(x)`` and an f-string
    of a numpy float scalar both give the float64 repr; an integer prints as
    itself."""
    if np.issubdtype(values.dtype, np.integer):
        return list(map(str, values.tolist()))
    return list(map(repr, values.astype(np.float64).tolist()))


def to_vtk(path: Union[str, Path], data: list) -> None:
    """Write named arrays to a legacy-ASCII VTK structured-points file.

    Args:
        path: output path (suffix .vtk enforced).
        data: list of (name, tensor_or_image_or_array[, Format]) tuples;
            the arrays share their two leading axes.  As in the JAX package,
            only those two axes span the grid (``nz = 1``), rows are written
            bottom-up, a vector is (v[1], -v[0], v[2] or 0.0), and a scalar
            or tensor field writes its first component.

    """
    path = Path(path).with_suffix(".vtk")
    path.parent.mkdir(parents=True, exist_ok=True)

    normalized = []
    for item in data:
        if len(item) == 3:
            name, array, fmt = item
        else:
            name, array = item
            fmt = Format.SCALAR
        normalized.append((name, _host(array), fmt))

    ny, nx = normalized[0][1].shape[:2]
    nz = 1

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("darsia_tpu export\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n")
        f.write("ORIGIN 0 0 0\n")
        f.write("SPACING 1 1 1\n")
        f.write(f"POINT_DATA {nx * ny * nz}\n")
        for name, array, fmt in normalized:
            flat = array.reshape(ny, nx, -1)[::-1]
            if fmt == Format.VECTOR and flat.shape[-1] >= 2:
                f.write(f"VECTORS {name} float\n")
                vx = _text(flat[..., 1].reshape(-1))
                vy = _text(-flat[..., 0].reshape(-1))
                vz = _text(flat[..., 2].reshape(-1)) if flat.shape[-1] > 2 else ["0.0"] * len(vx)
                f.write("".join(map("{} {} {}\n".format, vx, vy, vz)))
            else:
                f.write(f"SCALARS {name} float 1\n")
                f.write("LOOKUP_TABLE default\n")
                values = flat[..., 0].reshape(-1).astype(np.float64)
                f.write("".join(map("{!r}\n".format, values.tolist())))


def plot_2d_wasserstein_distance(info: dict, **kwargs) -> None:
    """Mass difference, pressure and the flux (its norm and a quiver) of a
    W1 solution side by side.  The flux norm and the quiver's samples are
    computed where the flux lies; only they are copied to the host."""
    plt = optional_module("matplotlib.pyplot", "plot_2d_wasserstein_distance")

    flux = info["flux"]
    if not isinstance(flux, torch.Tensor):
        flux = torch.from_numpy(np.asarray(flux))
    pressure = _host(info["pressure"])
    mass_diff = _host(info["mass_diff"])

    fig, axs = plt.subplots(1, 3, figsize=(15, 5))
    axs[0].imshow(mass_diff)
    axs[0].set_title("mass difference")
    axs[1].imshow(pressure)
    axs[1].set_title("pressure")
    axs[2].imshow(_host(torch.linalg.vector_norm(flux, dim=-1)))
    step = max(flux.shape[0] // 20, 1)
    Y, X = np.mgrid[0 : flux.shape[0] : step, 0 : flux.shape[1] : step]
    sampled = flux[::step, ::step]
    axs[2].quiver(
        X,
        Y,
        _host(sampled[..., 1]),
        _host(-sampled[..., 0]),
        color="white",
        scale=kwargs.get("scale", None),
    )
    axs[2].set_title("flux / transport density")
    if kwargs.get("path"):
        plt.savefig(kwargs["path"], dpi=kwargs.get("dpi", 300))
    if kwargs.get("show", True):
        plt.show()
    else:
        plt.close()
