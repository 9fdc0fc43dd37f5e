"""Row-resample kernels K1, K2 and K3, and the two-pass warp on K1.

Counterpart of :mod:`darsia_tpu.ops.pallas.warp2pass`.  Three hand-written
CUDA kernels replace its three ``pallas_call`` sites:

* K1, ``warp_rows_t`` (``csrc/warp_rows_t.cu``): the channel-batched row
  resample with a transposed output (``warp_rows_pallas_t``).  The two-pass
  warp (Catmull-Smith: resample along rows, then along columns) is two
  launches of it, the first writing its output transposed so the second
  reads rows again.
* K2 and K3, ``warp_rows`` (``csrc/warp_rows.cu``): the row resample with
  an untransposed output (``warp_rows_pallas``), on the plain schedule (K2)
  or the ring-buffer schedule (K3, ``ring=True``).  Same function, same bits.

The two sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
shared library each, both at once, into ``darsia_tpu_torch/_build/`` (plain
C entry points, bound with ``ctypes``; :mod:`.cuda_build`).
The wrappers launch them for CUDA tensors and take their plain PyTorch
versions, :func:`warp_rows_t_reference` and :func:`warp_rows_reference`, for
CPU tensors only.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..utils import tracing
from . import cuda_build

__all__ = [
    "build_kernel",
    "warp_rows",
    "warp_rows_reference",
    "warp_rows_t",
    "warp_rows_t_reference",
    "warp_two_pass",
    "warp_two_pass_planar",
]

_LANE = 128  # the Pallas lane tile whose window chain fixes the index clamp

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
#: Source stem in ``csrc/`` -> its C entry points and their argument types.
_SOURCES = {
    "warp_rows_t": {
        "darsia_warp_rows_t": [_PTR] * 3 + [_INT] * 6 + [_PTR],
        "darsia_warp_rows_t_geometry": [_INT] * 3 + [_PTR],
    },
    "warp_rows": {
        "darsia_warp_rows": [_PTR] * 3 + [_INT] * 5 + [_PTR],
        "darsia_warp_rows_ring": [_PTR] * 3 + [_INT] * 5 + [_PTR],
    },
}
#: K3 keeps nw chunks of 8 rows x 128 f32 in shared memory; a block can have
#: at most 227 KB of it on Hopper.
_RING_STRIP = 8
_MAX_SMEM = 232448

#: One build at a time: threads that first launch together wait for it.
_build_lock = threading.Lock()

_entries = None


def build_kernel() -> dict:
    """Compile (once per version of the sources and flags) and load K1, K2
    and K3; returns their C entry points by name.

    One ``nvcc`` per source, both started together, in the span
    ``k1.build``; threads that call it together wait for one build.
    """
    global _entries
    if _entries is not None:
        return _entries
    with _build_lock:
        if _entries is None:
            _entries = _build_and_bind()
    return _entries


def _build_and_bind() -> dict:
    return cuda_build.load(_SOURCES, "k1.build")


def _geometry(max_disp) -> tuple[int, int]:
    """(P, rel_max) of the Pallas kernels (warp2pass.py:155-162, :292-294)."""
    D = int(math.ceil(max_disp)) + 1
    num_windows = -(-(2 * D + _LANE + 1) // _LANE)
    return D, num_windows * _LANE - 2


def _plain_samples(cols: torch.Tensor, W_in: int, max_disp):
    """``(i0, i1, frac)``, each (R, W_out): the kernels' index arithmetic, op
    for op (f32 ``rel_f``, floor, chain-edge clamp)."""
    W_out = cols.shape[1]
    pad, rel_max = _geometry(max_disp)
    j = torch.arange(W_out, device=cols.device)
    tile_start = (j // _LANE) * _LANE
    rel_f = cols.clamp(0.0, float(W_in - 1)) + (
        float(pad) - tile_start.to(torch.float32)
    )
    base = torch.floor(rel_f)
    frac = rel_f - base
    p = tile_start + base.clamp(0.0, float(rel_max)).long() - pad
    return p.clamp(0, W_in - 1), (p + 1).clamp(0, W_in - 1), frac


def warp_rows_t_reference(
    data: torch.Tensor, cols: torch.Tensor, max_disp
) -> torch.Tensor:
    """Plain PyTorch K1: ``torch.gather`` on the edge-clamped index, the lerp
    without FMA, the output transposed."""
    C, R, W_in = data.shape
    i0, i1, frac = _plain_samples(cols, W_in, max_disp)
    v0 = torch.gather(data, 2, i0.expand(C, R, -1))
    v1 = torch.gather(data, 2, i1.expand(C, R, -1))
    return (v0 + frac * (v1 - v0)).transpose(1, 2).contiguous()


def warp_rows_reference(
    data: torch.Tensor, cols: torch.Tensor, max_disp
) -> torch.Tensor:
    """Plain PyTorch K2 and K3 (both schedules compute the same function):
    ``torch.gather`` on the edge-clamped index, the lerp without FMA."""
    i0, i1, frac = _plain_samples(cols, data.shape[1], max_disp)
    v0 = torch.gather(data, 1, i0)
    v1 = torch.gather(data, 1, i1)
    return v0 + frac * (v1 - v0)


def _takes_plain(fn: str, data, cols, ndim: int, impl: str) -> bool:
    """Checks shared by the kernel wrappers; True where the plain version
    runs (CPU tensors, or ``impl="plain"``)."""
    if data.dim() != ndim or cols.dim() != 2 or cols.shape[0] != data.shape[-2]:
        layout = "(C, R, W_in)" if ndim == 3 else "(R, W_in)"
        raise ValueError(
            f"{fn} needs data {layout} and cols (R, W_out); got "
            f"{tuple(data.shape)} and {tuple(cols.shape)}"
        )
    if data.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError(f"{fn} takes float32 data and cols")
    if data.device != cols.device:
        raise ValueError("data and cols must lie on the same device")
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or data.device.type == "cpu":
        return True
    if data.device.type != "cuda":
        raise ValueError(f"no {fn} kernel for device {data.device}")
    if not (data.is_contiguous() and cols.is_contiguous()):
        raise ValueError(f"the {fn} kernel takes contiguous data and cols")
    if min(*data.shape, cols.shape[1]) == 0:
        raise ValueError(f"the {fn} kernel takes no empty arrays")
    return False


def _check_index_range(fn: str, *numels: int) -> None:
    """The kernels index within these extents in 32-bit integers."""
    if max(numels) >= 2**31:
        raise ValueError(f"array too large for the {fn} kernel's 32-bit indices")


def _launch(name: str, data, cols, out, *ints) -> None:
    """Launch C entry ``name`` on the current stream; raise on its error."""
    entry = build_kernel()[name]
    # The launch is asynchronous on the current stream; PyTorch's caching
    # allocator reuses freed blocks in that stream's order, so the three
    # buffers stay valid until the kernel has read and written them.
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = entry(data.data_ptr(), cols.data_ptr(), out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def warp_rows_t(
    data: torch.Tensor, cols: torch.Tensor, max_disp, impl: str = "auto"
) -> torch.Tensor:
    """Channel-batched row resample with transposed output (K1).

    Args:
        data: (C, R, W_in) float32, contiguous.
        cols: (R, W_out) float32 fractional column positions shared by all
            channels, |cols[r, j] - j| <= max_disp, contiguous.
        max_disp: displacement bound.
        impl: "auto" (the kernel for CUDA tensors, the plain version for CPU
            tensors) or "plain" (the plain version on any device; for tests
            and checks only).

    Returns:
        (C, W_out, R): ``out[c, j, r] = data[c, r, cols[r, j]]``.

    """
    if _takes_plain("warp_rows_t", data, cols, 3, impl):
        return warp_rows_t_reference(data, cols, max_disp)
    C, R, W_in = data.shape
    W_out = cols.shape[1]
    # A persistent 1-D grid over (tile, channel group) items; channel planes
    # are offset in 64 bits, everything within a plane in 32.
    _check_index_range("warp_rows_t", R * W_in, R * W_out)
    pad, rel_max = _geometry(max_disp)
    out = torch.empty((C, W_out, R), dtype=torch.float32, device=data.device)
    _launch("darsia_warp_rows_t", data, cols, out, C, R, W_in, W_out, pad, rel_max)
    tracing.count("k1.launches")
    return out


def warp_rows_t_geometry(C: int, R: int, W_out: int) -> dict:
    """The launch geometry of K1 for these shapes on the current CUDA device:
    persistent grid size, resident blocks per SM, dynamic shared memory per
    block (bytes) and work items (tile x channel group)."""
    geometry = (ctypes.c_int * 4)()
    err = build_kernel()["darsia_warp_rows_t_geometry"](C, R, W_out, geometry)
    if err != 0:
        raise RuntimeError(f"darsia_warp_rows_t_geometry failed: cudaError {err}")
    return dict(zip(("grid", "blocks_per_sm", "smem_bytes", "items"), geometry))


def warp_rows(
    data: torch.Tensor,
    cols: torch.Tensor,
    max_disp,
    ring: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Row resample with untransposed output (K2, or K3 with ``ring``).

    Counterpart of ``warp_rows_pallas``.

    Args:
        data: (R, W_in) float32 (channels or batch folded into rows),
            contiguous.
        cols: (R, W_out) float32 fractional column positions,
            |cols[r, j] - j| <= max_disp, contiguous.
        max_disp: displacement bound.
        ring: run the ring-buffer schedule (K3) instead of the plain one (K2);
            the output is the same, bit for bit.
        impl: see :func:`warp_rows_t`.

    Returns:
        (R, W_out): ``out[r, j] = data[r, cols[r, j]]``.

    """
    if _takes_plain("warp_rows", data, cols, 2, impl):
        return warp_rows_reference(data, cols, max_disp)
    R, W_in = data.shape
    W_out = cols.shape[1]
    _check_index_range("warp_rows", R * W_in, R * W_out)
    pad, rel_max = _geometry(max_disp)
    if ring and (rel_max + 2) * _RING_STRIP * 4 > _MAX_SMEM:
        raise ValueError(f"max_disp {max_disp} needs more shared memory than K3 has")
    out = torch.empty((R, W_out), dtype=torch.float32, device=data.device)
    name = "darsia_warp_rows_ring" if ring else "darsia_warp_rows"
    _launch(name, data, cols, out, R, W_in, W_out, pad, rel_max)
    tracing.count("k3.launches" if ring else "k2.launches")
    return out


def warp_two_pass(
    data: torch.Tensor, coords: torch.Tensor, max_disp, impl: str = "auto"
) -> torch.Tensor:
    """Two-pass separable warp of an (H, W[, C]) image.

    Args:
        data: (H, W) or (H, W, C) float32.
        coords: (2, OH, OW) pull-back sampling positions (row, col).
        max_disp: bound on |coords - identity|.
        impl: see :func:`warp_rows_t`.

    Returns:
        (OH, OW[, C]) tensor.

    """
    squeeze = data.dim() == 2
    if squeeze:
        data = data[..., None]
    out = warp_two_pass_planar(data.permute(2, 0, 1), coords, max_disp, impl)
    out = out.permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def warp_two_pass_planar(
    data: torch.Tensor, coords: torch.Tensor, max_disp, impl: str = "auto"
) -> torch.Tensor:
    """Planar-layout (C, H, W) two-pass warp.

    Pass 1 gathers columns on input rows and emits (C, OW, H); pass 2 gathers
    the row field along the now-minor H axis and emits (C, OH, OW).  The
    column field is indexed by output rows; re-index it by (clamped) input
    rows: exact when OH == H, a smoothness-order approximation otherwise.
    """
    C, H, W = data.shape
    OH, OW = coords.shape[1:]
    cols_field = coords[1]
    if OH != H:
        row_ids = torch.arange(H, device=coords.device).clamp(0, OH - 1)
        cols_field = cols_field[row_ids]
    tmp_t = warp_rows_t(
        data.contiguous(), cols_field.contiguous(), max_disp, impl
    )  # (C, OW, H)
    rows_field = coords[0].transpose(0, 1).contiguous()  # (OW, OH)
    return warp_rows_t(tmp_t, rows_field, max_disp, impl)  # (C, OH, OW)
