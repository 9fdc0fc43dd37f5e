"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is its own shared library, compiled with ``nvcc``
for ``sm_90a`` at first use (once per version of the source and flags) into
``darsia_tpu_torch/_build/`` and bound with ``ctypes`` (plain C entry
points).  The module that launches a source declares its entry points and
their argument types beside its launches and asks for that source alone:
:mod:`~darsia_tpu_torch.ops.warp2pass` for K1-K3 (``warp_rows_t.cu``,
``warp_rows.cu``), :mod:`~darsia_tpu_torch.measure.beckmann_kernels` for the
pressure solve's CG trip (``tpfa_mg.cu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import tracing

__all__ = ["bind_entry", "compile_sources", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
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

#: ptxas log of each source compiled in this process, by source stem.
build_log: dict = {}

#: One build at a time: threads that first launch together wait for it.
_lock = threading.Lock()


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


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` is built: tagged with a hash of the source
    and the flags."""
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


def load(sources: dict, span: str) -> dict:
    """``{stem: {entry: argtypes}}`` -> ``{entry: bound C function}``.

    Compiles the sources not yet built (one ``nvcc`` each, all started
    together, in the span ``span``), loads them and binds the entries.
    """
    with _lock:
        libs = {stem: (CSRC / f"{stem}.cu", library_path(stem)) for stem in sources}
        todo = {stem: pair for stem, pair in libs.items() if not pair[1].is_file()}
        if todo:
            with tracing.span(span, sources=sorted(todo)):
                compile_sources(todo)
        return {
            name: bind_entry(ctypes.CDLL(str(libs[stem][1])), name, argtypes)
            for stem, entries in sources.items()
            for name, argtypes in entries.items()
        }


def compile_sources(jobs: dict) -> str:
    """Build ``{name: (source, library)}`` with the kernels' nvcc flags, one
    ``nvcc`` per source, all started together; returns their ptxas logs
    (also kept in :data:`build_log`).  Raises if any fails."""
    procs = []
    for name, (src, lib) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, tmp, lib, proc))
    logs, failed = [], []
    for name, tmp, lib, proc in procs:
        log = proc.communicate()[0]
        build_log[name] = log
        logs.append(f"[{name}]\n{log}")
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def bind_entry(library: ctypes.CDLL, name: str, argtypes: list):
    """C entry point ``name`` of a loaded kernel library, returning a
    ``cudaError_t`` as an int."""
    entry = getattr(library, name)
    entry.argtypes = argtypes
    entry.restype = ctypes.c_int
    return entry
