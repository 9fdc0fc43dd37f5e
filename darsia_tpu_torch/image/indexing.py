"""Axis-indexing conventions for physical images.

Counterpart of :mod:`darsia_tpu.image.indexing` (numpy only).  Images carry
their spatial axes in *matrix* indexing ("ij" in 2d, "ijk" in 3d) while
physical coordinates are Cartesian ("xy" / "xyz").  This module holds the
small, table-driven interpreters translating between the two conventions:

* 2d, matrix "ij": ``x`` maps to axis 1 (columns, not reversed); ``y`` maps to
  axis 0 (rows, reversed — row 0 is the *top* of the image).
* 3d, matrix "ijk": ``x`` maps to axis 1, ``y`` maps to axis 2 (reversed),
  ``z`` maps to axis 0 (reversed).

Everything here is static host-side metadata logic; no device compute.
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = [
    "interpret_indexing",
    "to_matrix_indexing",
    "to_cartesian_indexing",
    "matrixToCartesianIndexing",
    "cartesianToMatrixIndexing",
]

# interpret_indexing table: _INTERPRET[indexing][axis] = (component, reverted)
_F, _T = False, True
_INTERPRET: dict[str, dict[str, tuple[int, bool]]] = {
    "x": {"x": (0, _F), "i": (0, _F)},
    "i": {"x": (0, _F), "i": (0, _F)},
    "xy": {"x": (0, _F), "y": (1, _F), "i": (1, _T), "j": (0, _F)},
    "ij": {"x": (1, _F), "y": (0, _T), "i": (0, _F), "j": (1, _F)},
    "xyz": {
        "x": (0, _F),
        "y": (1, _F),
        "z": (2, _F),
        "i": (2, _T),
        "j": (0, _F),
        "k": (1, _T),
    },
    "ijk": {
        "x": (1, _F),
        "y": (2, _T),
        "z": (0, _T),
        "i": (0, _F),
        "j": (1, _F),
        "k": (2, _F),
    },
}

# Single-axis name translation tables.
_TO_MATRIX = {"xy": {"x": "j", "y": "i"}, "xyz": {"x": "k", "y": "j", "z": "i"}}
_TO_CARTESIAN = {"ij": {"i": "y", "j": "x"}, "ijk": {"i": "z", "j": "y", "k": "x"}}


def interpret_indexing(axis: str, indexing: str) -> tuple[int, bool]:
    """Locate ``axis`` within an ``indexing`` scheme.

    Args:
        axis: target axis, e.g. ``"x"`` or ``"i"``.
        indexing: indexing of an image, e.g. ``"ij"`` or ``"ijk"``.

    Returns:
        tuple: component position of the axis, and whether the axis direction
        is reverted when converting between matrix and Cartesian sense.

    Raises:
        ValueError: on unsupported combinations.

    """
    try:
        return _INTERPRET[indexing][axis]
    except KeyError as exc:
        raise ValueError(
            f"Unsupported axis/indexing combination: {axis!r}/{indexing!r}"
        ) from exc


def to_matrix_indexing(axis: Union[str, int], indexing: str) -> str:
    """Translate a Cartesian axis name to its matrix-indexing counterpart."""
    if isinstance(axis, int):
        axis = "xyz"[axis]
    try:
        return _TO_MATRIX[indexing][axis]
    except KeyError as exc:
        raise ValueError(f"Unsupported: {axis!r}/{indexing!r}") from exc


def to_cartesian_indexing(axis: Union[str, int], indexing: str) -> str:
    """Translate a matrix axis name to its Cartesian counterpart."""
    if isinstance(axis, int):
        axis = "ijk"[axis]
    try:
        return _TO_CARTESIAN[indexing][axis]
    except KeyError as exc:
        raise ValueError(f"Unsupported: {axis!r}/{indexing!r}") from exc


def matrixToCartesianIndexing(img: np.ndarray, dim: int = 2) -> np.ndarray:
    """Reorder array data from matrix (row, col) to Cartesian (x, y) layout.

    Useful when exporting to simulators which expect the lower-left corner at
    index (0, 0).
    """
    if dim == 1:
        return img
    if dim == 2:
        return np.flip(np.swapaxes(img, 0, 1), 1)
    if dim == 3:
        out = np.swapaxes(np.swapaxes(img, 0, 2), 0, 1)
        return np.flip(np.flip(out, 1), 2)
    raise ValueError("Only 1d, 2d, and 3d images are supported.")


def cartesianToMatrixIndexing(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`matrixToCartesianIndexing` (2d only)."""
    return np.swapaxes(np.flip(img, 1), 0, 1)
