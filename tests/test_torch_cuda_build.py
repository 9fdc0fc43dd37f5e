"""The build and binding of the port's CUDA sources (``ops/cuda_build.py``),
without ``nvcc`` or a card.

Each module declares the C entry points it launches, with their ctypes
argument types; a declaration that differs from the source's C signature in
count or kind would pass wrong arguments without an error, so every
declaration is held to the signature parsed from its source.  Each module
builds only its own sources, one library each, once.
"""

import ctypes
import re
from types import SimpleNamespace

import pytest

from darsia_tpu_torch.measure import beckmann_kernels
from darsia_tpu_torch.ops import cuda_build, warp2pass

DECLARED = [
    (stem, name, argtypes)
    for sources in (warp2pass._SOURCES, {"tpfa_mg": beckmann_kernels._ENTRIES})
    for stem, entries in sources.items()
    for name, argtypes in entries.items()
]


def _c_kinds(stem: str, name: str) -> list:
    """The ctypes kind of each parameter of C function ``name`` in
    ``csrc/<stem>.cu``: pointers (and the stream) as void pointers."""
    src = (cuda_build.CSRC / f"{stem}.cu").read_text()
    m = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", src)
    assert m, f"{name} is not defined in csrc/{stem}.cu"
    kinds = []
    for param in (p.strip() for p in m.group(1).split(",")):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("double"):
            kinds.append(ctypes.c_double)
        elif param.startswith("float"):
            kinds.append(ctypes.c_float)
        else:
            assert param.startswith("int "), param
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("stem,name,argtypes", DECLARED, ids=[d[1] for d in DECLARED])
def test_each_declared_entry_matches_its_c_signature(stem, name, argtypes):
    assert argtypes == _c_kinds(stem, name)


def test_every_c_entry_of_a_source_is_declared():
    declared = {(stem, name) for stem, name, _ in DECLARED}
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        for name in re.findall(r"\bint\s+(darsia_\w+)\s*\(", src.read_text()):
            assert (src.stem, name) in declared, f"{name} of {src.name} is not declared"


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """Builds recorded by source stem, each writing an empty library file;
    libraries "loaded" as objects with every entry."""
    built = []

    def compile_sources(jobs):
        built.append(sorted(jobs))
        for _, lib in jobs.values():
            lib.parent.mkdir(parents=True, exist_ok=True)
            lib.write_bytes(b"")
        return ""

    def cdll(path):
        return SimpleNamespace(**{name: lambda *a: 0 for _, name, _ in DECLARED})

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "compile_sources", compile_sources)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", cdll)
    return built


def test_each_module_builds_only_its_own_sources_once(fake_nvcc):
    lanes = warp2pass._build_and_bind()
    w1 = beckmann_kernels.build_kernels.__wrapped__()
    assert fake_nvcc == [["warp_rows", "warp_rows_t"], ["tpfa_mg"]]
    assert set(lanes) == set(warp2pass._SOURCES["warp_rows_t"]) | set(warp2pass._SOURCES["warp_rows"])
    assert set(w1) == set(beckmann_kernels._ENTRIES)
    for entry in {**lanes, **w1}.values():
        assert entry.restype is ctypes.c_int
    # Built on disk: loading again compiles nothing.
    warp2pass._build_and_bind()
    beckmann_kernels.build_kernels.__wrapped__()
    assert len(fake_nvcc) == 2


def test_a_changed_source_gets_a_new_library(monkeypatch):
    """The library's name hashes the source and the flags."""
    first = cuda_build.library_path("tpfa_mg")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build.library_path("tpfa_mg") != first
    assert cuda_build.library_path("warp_rows") != cuda_build.library_path("warp_rows_t")
