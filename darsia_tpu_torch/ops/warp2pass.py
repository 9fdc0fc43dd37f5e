"""Two-pass separable warp on a hand-written CUDA kernel (K1).

Counterpart of :mod:`darsia_tpu.ops.pallas.warp2pass`.  The row resample
``warp_rows_t`` is the kernel in ``csrc/warp_rows_t.cu``; the two-pass warp
(Catmull-Smith: resample along rows, then along columns) is two launches of
it, the first writing its output transposed so the second reads rows again.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
sources in the package, into ``darsia_tpu_torch/_build/`` (one shared
library with a plain C entry point, bound with ``ctypes``).  ``warp_rows_t``
launches it for CUDA tensors and takes its plain PyTorch version,
:func:`warp_rows_t_reference`, for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "build_kernel",
    "warp_rows_t",
    "warp_rows_t_reference",
    "warp_two_pass",
    "warp_two_pass_planar",
]

_LANE = 128  # the Pallas lane tile whose window chain fixes the index clamp

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "warp_rows_t.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

#: Kernel launches made by :func:`warp_rows_t` (plain-version calls do not
#: count).  Reset it to 0 before a run to see which path the run took.
launch_count = 0

#: ``{"seconds": ..., "log": ...}`` of the build in this process (None if the
#: library was already built on disk).
build_info = None

_entry = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit.")
    return found


def build_kernel():
    """Compile (once per source version) and load K1; returns its C entry."""
    global _entry, build_info
    if _entry is not None:
        return _entry
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"warp_rows_t_{digest}.so"
    if not lib_path.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        tic = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        build_info = {
            "seconds": time.perf_counter() - tic,
            "log": proc.stdout + proc.stderr,
        }
    lib = ctypes.CDLL(str(lib_path))
    entry = lib.darsia_warp_rows_t
    entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    _entry = entry
    return entry


def _geometry(max_disp) -> tuple[int, int]:
    """(P, rel_max) of the Pallas kernel (warp2pass.py:292-294, :257)."""
    D = int(math.ceil(max_disp)) + 1
    num_windows = -(-(2 * D + _LANE + 1) // _LANE)
    return D, num_windows * _LANE - 2


def warp_rows_t_reference(
    data: torch.Tensor, cols: torch.Tensor, max_disp
) -> torch.Tensor:
    """Plain PyTorch K1: ``torch.gather`` on the edge-clamped index.

    Same arithmetic as the kernel and the Pallas original, op for op (f32
    ``rel_f``, floor, chain-edge clamp, lerp without FMA).
    """
    C, R, W_in = data.shape
    W_out = cols.shape[1]
    pad, rel_max = _geometry(max_disp)
    j = torch.arange(W_out, device=data.device)
    tile_start = (j // _LANE) * _LANE
    rel_f = cols.clamp(0.0, float(W_in - 1)) + (
        float(pad) - tile_start.to(torch.float32)
    )
    base = torch.floor(rel_f)
    frac = rel_f - base
    p = tile_start + base.clamp(0.0, float(rel_max)).long() - pad
    i0 = p.clamp(0, W_in - 1).expand(C, R, W_out)
    i1 = (p + 1).clamp(0, W_in - 1).expand(C, R, W_out)
    v0 = torch.gather(data, 2, i0)
    v1 = torch.gather(data, 2, i1)
    return (v0 + frac * (v1 - v0)).transpose(1, 2).contiguous()


def warp_rows_t(
    data: torch.Tensor, cols: torch.Tensor, max_disp, impl: str = "auto"
) -> torch.Tensor:
    """Channel-batched row resample with transposed output.

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
    if data.dim() != 3 or cols.dim() != 2 or cols.shape[0] != data.shape[1]:
        raise ValueError(
            f"need data (C, R, W_in) and cols (R, W_out); got "
            f"{tuple(data.shape)} and {tuple(cols.shape)}"
        )
    if data.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError("warp_rows_t takes float32 data and cols")
    if data.device != cols.device:
        raise ValueError("data and cols must lie on the same device")
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or data.device.type == "cpu":
        return warp_rows_t_reference(data, cols, max_disp)
    if data.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {data.device}")
    if not (data.is_contiguous() and cols.is_contiguous()):
        raise ValueError("K1 takes contiguous data and cols")
    C, R, W_in = data.shape
    W_out = cols.shape[1]
    if min(C, R, W_in, W_out) == 0:
        raise ValueError("K1 takes no empty arrays")
    if max(data.numel(), cols.numel(), C * R * W_out) >= 2**31 or R > 65535 * 32:
        raise ValueError("array too large for K1's 32-bit launch geometry")
    pad, rel_max = _geometry(max_disp)
    entry = build_kernel()
    out = torch.empty((C, W_out, R), dtype=torch.float32, device=data.device)
    # The launch is asynchronous on the current stream; PyTorch's caching
    # allocator reuses freed blocks in that stream's order, so the three
    # buffers stay valid until the kernel has read and written them.
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = entry(
            data.data_ptr(),
            cols.data_ptr(),
            out.data_ptr(),
            C,
            R,
            W_in,
            W_out,
            pad,
            rel_max,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
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
