#!/usr/bin/env python3
"""Time K1 sources against each other on one CUDA card, in turns.

    python3 time_k1.py --design old=OLD.cu --design new=NEW.cu

A design is a CUDA source exporting K1's C entry point ``darsia_warp_rows_t``
(the signature of ``darsia_tpu_torch/csrc/warp_rows_t.cu``); for example the
parent commit's K1, ``git show HEAD~1:darsia_tpu_torch/csrc/warp_rows_t.cu``.
Every design is built as ``build_kernel`` builds the kernels (one nvcc each,
all started together) and its ptxas report printed.  Each is then held
bitwise against the plain version (``warp_rows_t_reference``) at every case,
and timed (``chip_smoke.cuda_ms(..., device_paced=True)``: the CUDA-event
mean of 20 launches queued behind a device spin; 3 rounds) at the cases of
``chip_smoke.py``: the two 4K production passes on the smoke's random field
(D = 120), and the frame's own launches (``chip_smoke.k1_cases``).  The
designs take turns within each round, in reverse order every other round, so
drift on the card shows as a spread between rounds.  Prints one line per
design and case: min and max ms, GB/s and share of the bound.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
ROUNDS = 3


def build(designs: dict) -> dict:
    """``{name: C entry}`` of each design's K1."""
    from darsia_tpu_torch.ops import cuda_build
    from darsia_tpu_torch.ops import warp2pass as w2p

    out_dir = cuda_build.BUILD_DIR / "designs"
    jobs = {name: (src, out_dir / f"{name}.so") for name, src in designs.items()}
    log = cuda_build.compile_sources(jobs)
    name = "?"
    for line in log.splitlines():
        if line.startswith("["):
            name = line.strip("[]")
        elif any(key in line for key in ("entry function", "registers", "spill")):
            print(f"ptxas [{name}]: {line.strip()}")
    return {
        name: cuda_build.bind_entry(
            ctypes.CDLL(str(lib)), "darsia_warp_rows_t",
            w2p._SOURCES["warp_rows_t"]["darsia_warp_rows_t"],
        )
        for name, (_, lib) in jobs.items()
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--design",
        action="append",
        required=True,
        metavar="NAME=PATH",
        help="a K1 source to time (repeatable)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k1: no CUDA device; this script runs only on a card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.ops import warp2pass as w2p

    designs = dict(d.split("=", 1) for d in args.design)
    device = torch.device("cuda:0")
    print(smoke.card_line())
    entries = build(designs)

    cases = []
    random_passes = [
        ("random pass 1", smoke.H, smoke.W, smoke.W),
        ("random pass 2", smoke.W, smoke.H, smoke.OH),
    ]
    for k, (name, R, W_in, W_out) in enumerate(random_passes):
        data, cols = smoke.rows_case(3, R, W_in, smoke.D_REG, W_out, seed=3 + k)
        cases.append({"name": name, "data": data, "cols": cols, "D": smoke.D_REG})
    lanes = smoke.build_lanes(dt, device)
    cases += smoke.k1_cases(w2p, lanes, device)
    del lanes

    stream = torch.cuda.current_stream(device).cuda_stream
    for case in cases:
        data, cols, D = case["data"], case["cols"], case["D"]
        C, R, W_in = data.shape
        W_out = cols.shape[1]
        pad, rel_max = w2p._geometry(D)
        ref = w2p.warp_rows_t_reference(data, cols, D)
        out = torch.empty_like(ref)
        ints = (C, R, W_in, W_out, pad, rel_max)

        def launch(entry, out=out, data=data, cols=cols, ints=ints):
            err = entry(data.data_ptr(), cols.data_ptr(), out.data_ptr(), *ints, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        case["launch"], case["bound"] = launch, smoke.k1_bound(C, R, W_in, W_out)
        case["ms"] = {name: [] for name in entries}
        for name, entry in entries.items():
            out.fill_(float("nan"))
            launch(entry)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = float((out - ref).abs().max())
                raise AssertionError(f"design {name}, {case['name']}: != plain ({err})")
        print(
            f"{case['name']} {tuple(data.shape)} -> {tuple(ref.shape)} D={D}: "
            "every design bitwise equal to the plain version"
        )
        del ref

    order = list(entries)
    for rnd in range(ROUNDS):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for case in cases:
                ms = smoke.cuda_ms(
                    lambda: case["launch"](entries[name]), 20, device_paced=True
                )
                case["ms"][name].append(ms)

    for case in cases:
        moved, bound_ms, bound_by = case["bound"]
        for name, ms in case["ms"].items():
            best = min(ms)
            print(
                f"{name:>12} | {case['name']:<22} | min {best:.4f} ms "
                f"(max {max(ms):.4f}) | "
                f"{moved / (best * 1e6):7.1f} GB/s | {100 * bound_ms / best:5.1f}% of "
                f"the {bound_ms:.4f} ms bound ({bound_by})"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
