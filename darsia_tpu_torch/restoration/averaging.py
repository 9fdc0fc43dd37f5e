"""REV volume averaging with porosity weighting.

Counterpart of :mod:`darsia_tpu.restoration.averaging`.  The uniform filter
is a box sum over the window divided by the number of voxels of the window
that lie inside the image; the window reaches ``(size - 1) // 2`` voxels
below and ``size // 2`` above its voxel, so an even size is off-centre, as
XLA's "SAME" padding places it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..image.image import as_numpy, as_tensor
from ..utils.morphology import binary_dilation, disk

__all__ = [
    "REV",
    "VolumeAveraging",
    "porosity_based_averaging",
    "uniform_filter",
    "volume_average",
]


def _window_counts(n: int, size: int, device) -> torch.Tensor:
    """Voxels of each window along an axis of length ``n`` inside the axis."""
    index = torch.arange(n, device=device)
    low, high = (size - 1) // 2, size // 2
    return ((index + high).clamp(max=n - 1) - (index - low).clamp(min=0) + 1).to(torch.float32)


def uniform_filter(data: torch.Tensor, size: int) -> torch.Tensor:
    """Local box mean of a 2-D tensor with edge-count normalization."""
    data = data.to(torch.float32)
    low, high = (size - 1) // 2, size // 2
    padded = F.pad(data[None, None], (low, high, low, high))
    # divisor_override=1 turns the pooling mean into the window's sum.
    summed = F.avg_pool2d(padded, size, stride=1, divisor_override=1)[0, 0]
    rows, cols = data.shape
    counts = _window_counts(rows, size, data.device)[:, None] * _window_counts(
        cols, size, data.device
    )
    return summed / counts


class REV:
    """Representative elementary volume, sized in physical units."""

    def __init__(self, size, img) -> None:
        if isinstance(size, float):
            size = [size] * img.coordinatesystem.dim
        cs = img.coordinatesystem
        self.size: int = max(
            int(cs.num_voxels(size[i], axis="xyz"[i])) for i in range(cs.dim)
        )


class VolumeAveraging:
    """Porosity-weighted local averaging over an REV window.

    ``mask`` (an Image, a tensor or a numpy array, which goes to ``device``,
    the CUDA card by default) decides the device; images and tensors given
    to the call must lie there.
    """

    def __init__(self, rev: REV, mask, labels=None, tol: float = 1e-12, device=None) -> None:
        self.rev_size = rev.size
        self.mask = mask
        self.labels = labels
        self._mask = as_tensor(mask.img if hasattr(mask, "img") else mask, device).to(
            torch.float32
        )
        self.mean_pore_volume = uniform_filter(self._mask, self.rev_size)
        self.zero_mask = self.mean_pore_volume < tol
        self._divisor = torch.where(
            self.zero_mask, torch.ones_like(self.mean_pore_volume), self.mean_pore_volume
        )

    def __call__(self, img):
        if hasattr(img, "img"):
            result = img.copy()
            result.img = self._average_array(img.img)
            return result
        return self._average_array(as_tensor(img, self._mask.device))

    def _average_array(self, arr: torch.Tensor) -> torch.Tensor:
        if arr.dim() == 2:
            return self._average_single(arr)
        if arr.dim() == 3:
            return torch.stack(
                [self._average_single(arr[..., i]) for i in range(arr.shape[-1])], dim=-1
            )
        raise ValueError("Only 2D and 3D arrays are supported.")

    def _average_single(self, arr: torch.Tensor) -> torch.Tensor:
        mean_masked = uniform_filter(arr.to(torch.float32) * self._mask, self.rev_size)
        result = mean_masked / self._divisor
        return torch.where(self.zero_mask, torch.zeros_like(result), result)


def volume_average(img, mask, size: float):
    """One-shot volume averaging."""
    return VolumeAveraging(rev=REV(size=size, img=img), mask=mask, device=img.device)(img)


def porosity_based_averaging(
    labels,
    porosity,
    ref_image,
    threshold: float = 0.3,
    disk_size: int = 5,
    rev_size: float = 0.005,
) -> VolumeAveraging:
    """Porosity-weighted volume averaging with deactivated layer boundaries:
    grains (porosity below ``threshold``) and the voxels within ``disk_size``
    of another label are left out of the averaging mask.  The mask is built
    on the host and lies on ``ref_image``'s device."""
    labels_arr = as_numpy(labels.img if hasattr(labels, "img") else labels)
    porosity_arr = np.array(
        as_numpy(porosity.img if hasattr(porosity, "img") else porosity), dtype=float
    )
    residual = np.zeros(labels_arr.shape, dtype=bool)
    footprint = disk(disk_size)
    for label in np.unique(labels_arr):
        mask = labels_arr == label
        residual |= mask & binary_dilation(~mask, footprint=footprint)
    porosity_arr[porosity_arr < threshold] = 0.0
    porosity_arr[residual] = 0.0
    return VolumeAveraging(
        rev=REV(size=rev_size, img=ref_image), mask=porosity_arr, device=ref_image.device
    )
