"""Host-to-device image transfer at 1.5 bytes per pixel (YUV 4:2:0).

Counterpart of :mod:`darsia_tpu.utils.transfer`.  ``put_rgb_yuv420`` ships
an (H, W, 3) uint8 RGB photograph as a full-resolution luma plane and two
chroma planes subsampled 2x2, and rebuilds the RGB frame on the device.
JPEG photographs store their chroma 4:2:0-subsampled already, so the round
trip loses a fraction of a uint8 level on photographs.

The split runs on the host in numpy (OpenCV is not part of the port's
environment): the BT.601 full-range conversion of OpenCV's ``RGB2YCrCb`` in
its 14-bit fixed point, and an area average to the ceil-half size as its
``INTER_AREA`` computes it (rounded half up), within one uint8 level of
OpenCV on odd shapes, where its fractional weights round differently.
The reconstruction runs in PyTorch on the planes' device: a bilinear chroma
upsample (half-pixel centres, edges held) and the 3x3 inverse matrix.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..image.image import as_tensor

__all__ = ["put_rgb_yuv420", "split_rgb_yuv420", "reconstruct_rgb_yuv420"]

# ITU-R BT.601 full range, as OpenCV's YCrCb conversion uses it.
_INV = np.array(
    [
        [1.0, 1.403, 0.0],  # R = Y + 1.403 (Cr-128)
        [1.0, -0.714, -0.344],  # G = Y - 0.714 (Cr-128) - 0.344 (Cb-128)
        [1.0, 0.0, 1.773],  # B = Y + 1.773 (Cb-128)
    ],
    dtype=np.float32,
)
_SHIFT = 14


def _area_weights(n_in: int, n_out: int) -> tuple:
    """(indices, weights), each (n_out, K): the input cells each output
    cell of an area resample overlaps, and the overlap over the cell's
    width."""
    scale = n_in / n_out
    k = math.ceil(scale) + 1
    start = np.arange(n_out) * scale
    first = np.floor(start).astype(np.int64)
    idx = first[:, None] + np.arange(k)[None, :]
    lo = np.maximum(start[:, None], idx)
    hi = np.minimum(start[:, None] + scale, idx + 1)
    weights = np.clip(hi - lo, 0.0, None) / scale
    return np.minimum(idx, n_in - 1), weights


def _area_resize(plane: np.ndarray, shape: tuple) -> np.ndarray:
    """Area-average a (H, W) plane to ``shape`` (OpenCV's ``INTER_AREA``
    for a downsampling), rounded to uint8."""
    out = plane.astype(np.float64)
    for axis, n_out in enumerate(shape):
        idx, weights = _area_weights(out.shape[axis], n_out)
        moved = np.moveaxis(out, axis, 0)
        out = np.moveaxis(np.einsum("ok,ok...->o...", weights, moved[idx]), 0, axis)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def split_rgb_yuv420(rgb_u8: np.ndarray) -> tuple:
    """Host-side split of an (H, W, 3) uint8 RGB frame into
    ``(y, cr_half, cb_half)`` uint8 planes (chroma at ceil-half size)."""
    assert rgb_u8.ndim == 3 and rgb_u8.shape[-1] == 3, rgb_u8.shape
    rgb = np.asarray(rgb_u8, dtype=np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    # OpenCV's 14-bit fixed point: 0.299, 0.587, 0.114; 0.713 and 0.564.
    half = 1 << (_SHIFT - 1)
    luma = (r * 4899 + g * 9617 + b * 1868 + half) >> _SHIFT
    bias = (128 << _SHIFT) + half
    y = luma.astype(np.uint8)
    cr = np.clip(((r - luma) * 11682 + bias) >> _SHIFT, 0, 255).astype(np.uint8)
    cb = np.clip(((b - luma) * 9241 + bias) >> _SHIFT, 0, 255).astype(np.uint8)
    h, w = y.shape
    shape = ((h + 1) // 2, (w + 1) // 2)
    return y, _area_resize(cr, shape), _area_resize(cb, shape)


def reconstruct_rgb_yuv420(y, cr, cb, out_dtype=np.uint8, device=None) -> torch.Tensor:
    """The RGB frame from YUV420 planes, on the planes' device (numpy planes
    go to ``device``, the CUDA card when None)."""
    y, cr, cb = (as_tensor(p, device) for p in (y, cr, cb))
    h, w = y.shape
    inv = torch.from_numpy(_INV).to(y.device)

    def upsample(plane: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(
            plane.to(torch.float32)[None, None], size=(h, w), mode="bilinear", align_corners=False
        )
        return up[0, 0] - 128.0

    planes = torch.stack([y.to(torch.float32), upsample(cr), upsample(cb)], dim=-1)
    rgb = planes @ inv.T
    dtype = torch.from_numpy(np.empty(0, dtype=out_dtype)).dtype
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(dtype)


def put_rgb_yuv420(rgb_u8: np.ndarray, out_dtype=np.uint8, device=None) -> torch.Tensor:
    """Transfer an (H, W, 3) uint8 RGB host frame to ``device`` (None: the
    CUDA card) at 1.5 bytes per pixel and return the reconstructed (H, W, 3)
    tensor there."""
    y, cr, cb = split_rgb_yuv420(rgb_u8)
    return reconstruct_rgb_yuv420(y, cr, cb, out_dtype=out_dtype, device=device)
