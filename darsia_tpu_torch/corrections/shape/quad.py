"""Quadrilateral ROI extraction via a projective warp.

Counterpart of :mod:`darsia_tpu.corrections.shape.quad`: the 3x3 homography
is solved exactly on the host (8x8 system, float64) and the resampling is the
shared warp, so a crop inside a correction chain fuses with the rest of it.
The output size follows the physical aspect ratio (``width``/``height``),
as the curvature and checker crops use it, or an explicit ``shape``; a
bilinear crop warps through K1 on CUDA, a nearest one through the gather
warp.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

from ...image.image import as_tensor, card_unless
from ...ops.warp import perspective_grid, warp_backend
from ...utils.point import VoxelArray

__all__ = ["extract_quadrilateral_ROI", "homography_from_points", "quad_coordinate_grid"]


def homography_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 4-point homography H with ``H @ [src, 1] ~ [dst, 1]`` (DLT solve)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != (4, 2) or dst.shape != (4, 2):
        raise ValueError("a homography needs 4 source and 4 destination points")
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i : 2 * i + 2] = [u, v]
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def quad_coordinate_grid(
    pts_src_rowcol: np.ndarray,
    out_shape: tuple,
    pts_dst_rowcol: Optional[np.ndarray] = None,
    device=None,
) -> torch.Tensor:
    """(2, H, W) pull-back field of a quadrilateral -> rectangle warp.

    Args:
        pts_src_rowcol: 4 source corners (row, col): top-left, bottom-left,
            bottom-right, top-right.
        out_shape: (height, width) of the output.
        pts_dst_rowcol: the 4 destination points (row, col); by default the
            output's corners.
        device: device of the field (default: the CUDA card).

    """
    height, width = out_shape
    if pts_dst_rowcol is None:
        pts_dst_rowcol = np.array(
            [[0, 0], [height - 1, 0], [height - 1, width - 1], [0, width - 1]],
            dtype=np.float64,
        )
    # Destination (row, col) -> source (row, col): the pull-back map.
    H = homography_from_points(pts_dst_rowcol, np.asarray(pts_src_rowcol))
    return perspective_grid(
        torch.as_tensor(H, dtype=torch.float32, device=card_unless(device, "the field")),
        (height, width),
    )


def _rowcol(points, indexing: str) -> np.ndarray:
    """(row, col) float64 corners: a VoxelArray holds them; plain points are
    (x, y) pairs under "reverse matrix"."""
    rc = np.asarray(points, dtype=np.float64)
    if not isinstance(points, VoxelArray) and indexing == "reverse matrix":
        rc = rc[:, ::-1]
    return rc


def extract_quadrilateral_ROI(
    img_src,
    pts_src=None,
    indexing: Literal["matrix", "reverse matrix"] = "reverse matrix",
    interpolation: str = "inter_linear",
    **kwargs,
) -> torch.Tensor:
    """Warp the quadrilateral ``pts_src`` of an image onto a rectangle.

    Args:
        img_src: (H, W[, C]) tensor (a numpy array goes to the card).
        pts_src: 4 corner points, upper-left first, counter-clockwise (a
            VoxelArray in (row, col); plain points per ``indexing``); None for
            the image's own corners ``(0, 0), (H, 0), (H, W), (0, W)``.
        indexing: whether plain points are (row, col) ("matrix") or (x, y)
            ("reverse matrix") pairs.
        interpolation: "inter_linear" (the warp of ``warp_backend``: K1 on
            CUDA within its bound) or "inter_nearest" (the gather warp,
            order 0).
        kwargs: ``width`` and ``height``, the physical target dimensions
            (their ratio fixes the output's aspect ratio inside the input's
            size), or ``shape``, the output's (height, width), unclipped (the
            input's shape by default); optional ``pts_dst``, the 4
            destination points (as ``pts_src``).

    """
    img_src = as_tensor(img_src)
    original_height, original_width = img_src.shape[:2]
    if "width" in kwargs and "height" in kwargs:
        aspect_ratio = float(kwargs["width"]) / float(kwargs["height"])
        width = min(original_width, int(aspect_ratio * float(original_height)))
        height = min(original_height, int(1.0 / aspect_ratio * float(original_width)))
    else:
        height, width = kwargs.get("shape", (original_height, original_width))

    if pts_src is None:
        H, W = original_height, original_width
        pts_rc = np.array([[0, 0], [H, 0], [H, W], [0, W]], dtype=np.float64)
    else:
        pts_rc = _rowcol(pts_src, indexing)
    pts_dst_rc = _rowcol(kwargs["pts_dst"], indexing) if "pts_dst" in kwargs else None

    coords = quad_coordinate_grid(pts_rc, (height, width), pts_dst_rc, device=img_src.device)
    order = 0 if interpolation == "inter_nearest" else 1
    out = warp_backend(img_src.to(torch.float32), coords, order=order)
    if not img_src.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(img_src.dtype)
