"""Low-resolution PNG previews for GUI streaming.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.streaming`.  The
PNG encoding needs OpenCV, imported when called; where it does not import
:func:`encode_low_resolution_png` raises ``ImportError`` naming it.
The publishers keep the JAX package's log-and-continue: a preview is a GUI
convenience, not part of the analysis, and its failure never stops a loop.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ....image.image import as_numpy
from ....utils.optional import optional_module

__all__ = [
    "encode_low_resolution_png",
    "publish_preview",
    "publish_stream_images",
    "publish_stream_payload",
]


def _to_uint8_rgb(image_like: Any) -> np.ndarray:
    array = as_numpy(image_like.img if hasattr(image_like, "img") else image_like)
    if array.ndim == 2:
        array = np.stack([array] * 3, axis=-1)
    if array.ndim != 3 or array.shape[2] < 3:
        raise ValueError(f"Unsupported image shape for streaming: {array.shape}.")
    rgb = array[..., :3]
    if rgb.dtype == np.uint8:
        return rgb
    rgb = np.asarray(rgb, dtype=float)
    lo, hi = np.nanmin(rgb), np.nanmax(rgb)
    if lo >= 0.0 and hi <= 1.0:
        return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    span = max(hi - lo, 1e-12)
    return np.clip((rgb - lo) / span * 255.0, 0, 255).astype(np.uint8)


def encode_low_resolution_png(image_like: Any, max_width: int = 640, max_height: int = 480) -> bytes:
    """A downscaled PNG preview of an image (bytes); needs OpenCV."""
    cv2 = optional_module("cv2", "encoding a PNG preview")

    rgb = _to_uint8_rgb(image_like)
    height, width = rgb.shape[:2]
    if width == 0 or height == 0:
        raise ValueError("Cannot encode an image with zero dimensions.")
    scale = min(max_width / width, max_height / height, 1.0)
    if scale < 1.0:
        rgb = cv2.resize(
            rgb,
            (max(int(width * scale), 1), max(int(height * scale), 1)),
            interpolation=cv2.INTER_AREA,
        )
    ok, buffer = cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    if not ok:
        raise RuntimeError("PNG encoding failed.")
    return bytes(buffer)


def publish_preview(stream_callback: Optional[Callable[[bytes], None]], image_like: Any) -> None:
    """Best-effort preview publication (never raises into the hot loop)."""
    if stream_callback is None:
        return
    try:
        stream_callback(encode_low_resolution_png(image_like))
    except Exception:
        pass


def publish_stream_payload(stream_callback, payload: dict, logger=None, error_message: str = "") -> None:
    """Publish an already-encoded payload, guarding callback failures; a
    failing callback is signalled with a None payload."""
    if stream_callback is None:
        return
    try:
        stream_callback(payload)
    except Exception:
        if logger is not None and error_message:
            logger.exception(error_message)
        try:
            stream_callback(None)
        except Exception:
            pass


def publish_stream_images(
    stream_callback=None,
    image_payload=None,
    logger=None,
    error_message: str = "",
) -> None:
    """Encode and publish a dict of preview images (best-effort)."""
    if stream_callback is None or not image_payload:
        return
    try:
        encoded = {
            key: encode_low_resolution_png(image)
            for key, image in image_payload.items()
            if image is not None
        }
        stream_callback(encoded)
    except Exception:
        if logger is not None and error_message:
            logger.warning(error_message)
