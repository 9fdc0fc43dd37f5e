"""Dtype conversion with value-range rescaling.

Counterpart of :mod:`darsia_tpu.utils.dtype`: integer image types map to
[0, 1] floats and back.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_torch_dtype", "convert_dtype", "host_float32"]

_RANGES = {torch.uint8: 255.0, torch.uint16: 65535.0}

_FROM_NUMPY = {
    np.dtype(bool): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or numpy type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _FROM_NUMPY[np.dtype(dtype)]


def convert_dtype(img: torch.Tensor, dtype) -> torch.Tensor:
    """Convert between image dtypes, rescaling integer ranges to [0, 1]."""
    dtype = as_torch_dtype(dtype)
    if img.dtype == dtype:
        return img
    out = img.to(torch.float32)
    src_range = _RANGES.get(img.dtype)
    dst_range = _RANGES.get(dtype)
    if src_range is not None:
        out = out / src_range
    if dst_range is not None:
        out = (out * dst_range).round().clamp(0, dst_range)
    return out.to(dtype)


def host_float32(arr: np.ndarray) -> np.ndarray:
    """A host image as float32, integer ranges mapped to [0, 1] through
    float64, as the JAX package converts numpy images."""
    if arr.dtype in (np.uint8, np.uint16):
        return (arr.astype(np.float64) / np.iinfo(arr.dtype).max).astype(np.float32)
    return arr
