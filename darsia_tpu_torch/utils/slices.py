"""Slice arithmetic helpers (counterpart of :mod:`darsia_tpu.utils.slices`)
and array slicing utilities; plain Python, copied."""

from __future__ import annotations

__all__ = [
    "add_slices",
    "add_slice_pairs",
    "subtract_slices",
    "subtract_slice_pairs",
    "array_slice",
    "array_slice_argument",
]


def add_slices(slice1: slice, slice2: slice) -> slice:
    return slice(slice1.start + slice2.start, slice1.stop + slice2.stop)


def add_slice_pairs(pair1, pair2):
    return tuple(add_slices(a, b) for a, b in zip(pair1, pair2))


def subtract_slices(slice1: slice, slice2: slice) -> slice:
    return slice(slice1.start - slice2.start, slice1.stop - slice2.stop)


def subtract_slice_pairs(pair1, pair2):
    return tuple(subtract_slices(a, b) for a, b in zip(pair1, pair2))


def array_slice_argument(arr, axis: int, start, stop, step=None):
    """Index tuple selecting [start:stop:step] along ``axis``."""
    return (slice(None),) * (axis % arr.ndim) + (slice(start, stop, step),)


def array_slice(arr, axis: int, start, stop, step=None):
    """Slice [start:stop:step] along ``axis``."""
    return arr[array_slice_argument(arr, axis, start, stop, step)]
