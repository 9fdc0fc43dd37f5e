"""Quadrilateral ROI extraction via a projective warp.

Counterpart of :mod:`darsia_tpu.corrections.shape.quad`: the 3x3 homography
is solved exactly on the host (8x8 system, float64) and the resampling is the
shared warp, so a crop inside a correction chain fuses with the rest of it.
Corner points are plain lists or arrays; the output size follows the
physical aspect ratio (``width``/``height``), as the curvature crop uses it.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ...ops.warp import perspective_grid, warp_backend

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
    pts_src_rowcol: np.ndarray, out_shape: tuple, device
) -> torch.Tensor:
    """(2, H, W) pull-back field of a quadrilateral -> rectangle warp.

    Args:
        pts_src_rowcol: 4 source corners (row, col): top-left, bottom-left,
            bottom-right, top-right.
        out_shape: (height, width) of the output.
        device: device of the field.

    """
    height, width = out_shape
    pts_dst_rowcol = np.array(
        [[0, 0], [height - 1, 0], [height - 1, width - 1], [0, width - 1]],
        dtype=np.float64,
    )
    # Destination (row, col) -> source (row, col): the pull-back map.
    H = homography_from_points(pts_dst_rowcol, np.asarray(pts_src_rowcol))
    return perspective_grid(
        torch.as_tensor(H, dtype=torch.float32, device=device), (height, width)
    )


def extract_quadrilateral_ROI(
    img_src: torch.Tensor,
    pts_src,
    width: float,
    height: float,
    indexing: Literal["matrix", "reverse matrix"] = "reverse matrix",
) -> torch.Tensor:
    """Warp the quadrilateral ``pts_src`` of an image onto a rectangle.

    Args:
        img_src: (H, W[, C]) tensor.
        pts_src: 4 corner points, upper-left first, counter-clockwise.
        width, height: physical target dimensions; their ratio fixes the
            output's aspect ratio inside the input's size.
        indexing: whether ``pts_src`` holds (row, col) ("matrix") or
            (x, y) ("reverse matrix") pairs.

    """
    original_height, original_width = img_src.shape[:2]
    aspect_ratio = float(width) / float(height)
    out_width = min(original_width, int(aspect_ratio * float(original_height)))
    out_height = min(original_height, int(1.0 / aspect_ratio * float(original_width)))
    pts = np.asarray(pts_src, dtype=np.float64)
    pts_rc = pts[:, ::-1] if indexing == "reverse matrix" else pts

    coords = quad_coordinate_grid(pts_rc, (out_height, out_width), img_src.device)
    out = warp_backend(img_src.to(torch.float32), coords, order=1)
    if not img_src.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(img_src.dtype)
