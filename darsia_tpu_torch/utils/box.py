"""Bounding-box helpers.

Counterpart of :mod:`darsia_tpu.utils.box` (host-side numpy, a copy).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .point import VoxelArray, make_voxel

__all__ = ["bounding_box", "bounding_box_inverse", "perimeter", "random_patches"]


def bounding_box(
    voxels: np.ndarray,
    padding: int = 0,
    max_size: Optional[list[int]] = None,
) -> tuple[slice, ...]:
    """Axis-aligned bounding box of a voxel collection, as slices.

    Args:
        voxels: (N, dim) array of voxel indices.
        padding: enlarge the box by this many voxels per side.
        max_size: clamp per-axis upper bounds (e.g. image shape).

    """
    arr = np.atleast_2d(np.asarray(voxels))
    slices = []
    for axis in range(arr.shape[1]):
        lo = max(int(arr[:, axis].min()) - padding, 0)
        hi = int(arr[:, axis].max()) + padding
        if max_size is not None:
            hi = min(hi, max_size[axis])
        slices.append(slice(lo, hi))
    return tuple(slices)


def bounding_box_inverse(box: tuple[slice, ...]) -> VoxelArray:
    """Corner voxels of a bounding box (inverse of :func:`bounding_box`)."""
    if len(box) == 2:
        corners = [
            [box[0].start, box[1].start],
            [box[0].stop, box[1].start],
            [box[0].stop, box[1].stop],
            [box[0].start, box[1].stop],
        ]
    else:
        corners = [
            [i, j, k]
            for i in (box[0].start, box[0].stop)
            for j in (box[1].start, box[1].stop)
            for k in (box[2].start, box[2].stop)
        ]
    return make_voxel(np.array(corners))


def perimeter(box: Union[tuple, np.ndarray]) -> Union[int, float]:
    """Perimeter of a 2-D box given as slices or a corner array."""
    if isinstance(box, tuple):
        h = box[0].stop - box[0].start
        w = box[1].stop - box[1].start
    else:
        arr = np.asarray(box)
        h = arr[:, 0].max() - arr[:, 0].min()
        w = arr[:, 1].max() - arr[:, 1].min()
    return 2 * (h + w)


def random_patches(
    shape: tuple[int, int],
    width: int,
    num_patches: int,
    rng: Optional[np.random.Generator] = None,
) -> list[tuple[slice, slice]]:
    """Random square patches (slice tuples) within ``shape``."""
    rng = rng or np.random.default_rng()
    rows = rng.integers(0, max(shape[0] - width, 1), size=num_patches)
    cols = rng.integers(0, max(shape[1] - width, 1), size=num_patches)
    return [
        (slice(int(r), int(r) + width), slice(int(c), int(c) + width))
        for r, c in zip(rows, cols)
    ]
