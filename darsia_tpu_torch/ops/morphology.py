"""Binary morphology of 2-D masks as boolean tensor ops on the mask's device.

The cross-shaped (4-neighbour) erosion and dilation treat pixels outside
the mask as ``False``, as ``scipy.ndimage``'s ``border_value=0`` does for
both; :func:`skeletonize` is Lantuejoul's skeleton of
``utils/morphology.py::skeletonize`` (the host version, which stays as the
plain reference) bit for bit: per iteration one erosion, the opening as the
dilation of that erosion, and one ``.any()`` read of the eroded mask, the
loop's only host read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dilate_cross", "erode_cross", "neighbour_count", "skeletonize"]


def _padded(mask: torch.Tensor) -> torch.Tensor:
    return F.pad(mask, (1, 1, 1, 1), value=False)


def erode_cross(mask: torch.Tensor) -> torch.Tensor:
    """``ndimage.binary_erosion`` with the 3x3 cross, border value 0."""
    p = _padded(mask)
    return mask & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]


def dilate_cross(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """``ndimage.binary_dilation(mask, iterations=...)`` with the 3x3 cross,
    border value 0, over the last two axes of a boolean tensor."""
    out = mask
    for _ in range(iterations):
        grown = out.clone()
        grown[..., 1:, :] |= out[..., :-1, :]
        grown[..., :-1, :] |= out[..., 1:, :]
        grown[..., :, 1:] |= out[..., :, :-1]
        grown[..., :, :-1] |= out[..., :, 1:]
        out = grown
    return out


def neighbour_count(mask: torch.Tensor) -> torch.Tensor:
    """Per pixel the number of ``True`` pixels in its 3x3 window, itself
    included (``ndimage.convolve`` with ones, mode "constant"), as int32."""
    p = _padded(mask).to(torch.int32)
    h, w = mask.shape
    count = torch.zeros((h, w), dtype=torch.int32, device=mask.device)
    for dr in range(3):
        for dc in range(3):
            count += p[dr : dr + h, dc : dc + w]
    return count


def skeletonize(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The morphological skeleton of a 2-D boolean mask and the number of
    erosions it took (the loop's iterations)."""
    eroded = mask.to(torch.bool)
    skeleton = torch.zeros_like(eroded)
    iterations = 0
    while bool(eroded.any()):
        next_eroded = erode_cross(eroded)
        opened = dilate_cross(next_eroded)
        skeleton |= eroded & ~opened
        eroded = next_eroded
        iterations += 1
    return skeleton, iterations
