"""K1, the port's two-pass row-resample kernel (``csrc/warp_rows_t.cu``):
its launches in the analysis lane and the bytes each needs.

A launch reads its (C, R, W_in) float32 data and its (R, W_out) column map
once and writes its (C, W_out, R) output once; the lerp's few operations per
output are far below the card's float32 rate, so bytes bound it.
"""

from __future__ import annotations

#: Substring of K1's kernel name in a profiler trace.
NAME = "warp_rows_t_kernel"


def bytes_per_launch(C: int, R: int, W_in: int, W_out: int) -> int:
    return 4 * (C * R * W_in + R * W_out + C * W_out * R)


def crop_shape(H: int, W: int, width: float, height: float) -> tuple:
    """The curvature crop's output (rows, cols) for a frame of H x W."""
    aspect = float(width) / float(height)
    return min(H, int(1.0 / aspect * float(W))), min(W, int(aspect * float(H)))


def lane_launches(cfg: dict) -> list:
    """(C, R, W_in, W_out) of the four K1 launches of one frame of the
    two-warp lane: the correction warp (H x W -> OH x OW) and the
    registration warp (OH x OW -> OH x OW), each a row pass then a column
    pass on the transposed intermediate."""
    fr, crop = cfg["frame"], cfg["curvature"]["crop"]
    C, H, W = fr["channels"], fr["height"], fr["width"]
    OH, OW = crop_shape(H, W, crop["width"], crop["height"])
    return [
        (C, H, W, OW),
        (C, OW, H, OH),
        (C, OH, OW, OW),
        (C, OW, OH, OH),
    ]


def lane_bytes_per_frame(cfg: dict) -> int:
    return sum(bytes_per_launch(*shape) for shape in lane_launches(cfg))
