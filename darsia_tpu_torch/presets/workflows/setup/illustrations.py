"""Illustration images of setup products (depth map, labels, facies).

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.illustrations`.
The pictures are by-products of a setup step: where matplotlib does not
import (as on a machine without it), each function warns once, naming
matplotlib, and writes nothing, so the step's ``.npz`` product is written
all the same.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Optional
from warnings import warn

import numpy as np

from ....image.image import as_numpy

__all__ = ["save_discrete_map_illustration", "save_scalar_map_illustration"]

_warned = False


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (warned once) when
    matplotlib is not installed."""
    global _warned
    try:
        matplotlib = importlib.import_module("matplotlib")
    except ImportError:
        if not _warned:
            warn("matplotlib is not installed: setup illustrations are not drawn")
            _warned = True
        return None
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def _to_2d(array) -> np.ndarray:
    array = as_numpy(array)
    if array.ndim == 3 and array.shape[-1] == 1:
        return array[..., 0]
    if array.ndim != 2:
        raise ValueError(f"Expected 2d map, got shape {array.shape}.")
    return array


def save_scalar_map_illustration(
    data, path: Path, title: str = "", colorbar_label: str = ""
) -> Optional[Path]:
    """Draw a scalar map with a colour bar into ``path``; None when
    matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return None
    arr = _to_2d(data.img if hasattr(data, "img") else data)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    im = ax.imshow(arr)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label=colorbar_label)
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path


def save_discrete_map_illustration(
    data, path: Path, title: str = "", show_ids: bool = True
) -> Optional[Path]:
    """Draw a label map (with each label's id at its centre) into ``path``;
    None when matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return None
    from scipy import ndimage

    arr = _to_2d(data.img if hasattr(data, "img") else data).astype(int)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    ax.imshow(arr, cmap="tab20", interpolation="nearest")
    if show_ids:
        for label in np.unique(arr):
            center = ndimage.center_of_mass(arr == label)
            ax.text(
                center[1],
                center[0],
                str(int(label)),
                color="white",
                ha="center",
                va="center",
                fontsize=8,
                bbox={"facecolor": "black", "alpha": 0.5, "pad": 1},
            )
    ax.set_title(title)
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path
