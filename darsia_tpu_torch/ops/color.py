"""Color reductions (the part the main path uses).

Counterpart of :mod:`darsia_tpu.ops.color`.
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray"]

# ITU-R BT.601 luma weights.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Luma grayscale of an (..., 3) image, preserving the input scale."""
    x = rgb.to(torch.float32)
    weights = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=x.device)
    gray = torch.tensordot(x, weights, dims=([-1], [0]))
    if not rgb.dtype.is_floating_point:
        return torch.round(gray).to(rgb.dtype)
    return gray.to(rgb.dtype)
