"""Host-to-device image transfer at 1.5 bytes per pixel (YUV 4:2:0).

Counterpart of :mod:`darsia_tpu.utils.transfer`.  ``put_rgb_yuv420`` ships
an (H, W, 3) uint8 RGB photograph as a full-resolution luma plane and two
chroma planes subsampled 2x2, and rebuilds the RGB frame on the device.
JPEG photographs store their chroma 4:2:0-subsampled already, so the round
trip loses a fraction of a uint8 level on photographs.

The split runs on the host with OpenCV, as the JAX package's does (imported
when called): ``cvtColor`` to YCrCb and an ``INTER_AREA`` resample of the
chroma planes to the ceil-half size.
The reconstruction runs in PyTorch on the planes' device: a bilinear chroma
upsample (half-pixel centres, edges held) and the 3x3 inverse matrix.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..image.image import as_tensor
from .optional import optional_module

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


def split_rgb_yuv420(rgb_u8: np.ndarray) -> tuple:
    """Host-side split of an (H, W, 3) uint8 RGB frame into
    ``(y, cr_half, cb_half)`` uint8 planes (chroma at ceil-half size)."""
    cv2 = optional_module("cv2", "the YUV 4:2:0 split")
    assert rgb_u8.ndim == 3 and rgb_u8.shape[-1] == 3, rgb_u8.shape
    ycrcb = cv2.cvtColor(np.ascontiguousarray(rgb_u8), cv2.COLOR_RGB2YCrCb)
    h, w = ycrcb.shape[:2]
    half = ((w + 1) // 2, (h + 1) // 2)
    cr = cv2.resize(ycrcb[..., 1], half, interpolation=cv2.INTER_AREA)
    cb = cv2.resize(ycrcb[..., 2], half, interpolation=cv2.INTER_AREA)
    return ycrcb[..., 0], cr, cb


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
