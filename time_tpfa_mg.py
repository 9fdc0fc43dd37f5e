#!/usr/bin/env python3
"""Time the pressure solve's CG-trip kernels (``csrc/tpfa_mg.cu``) on one
CUDA card at the W1 benchmark's shapes, beside their byte bounds, their
plain mirror and the tensor CG.

    python3 time_tpfa_mg.py [--batch 1024] [--shape 120 280]

Each kernel: the CUDA-event mean of 20 launches queued behind a device spin
(``chip_smoke.cuda_ms(..., device_paced=True)``); its bytes (each input read
once, each output written once) over 3.35 TB/s; the same step of the plain
mirror (``FusedMGPCG(kernels=False)``; per V-cycle level the tensor
V-cycle's steps; 5 runs), as ``chip_smoke.cg_kernel_rows`` lists them for
phase S.  Then a whole trip, from two
fixed-count solves (tol 0) differenced, with the host's flag read a trip:
the kernels' (``mg_pcg_fused``) against the tensor CG's (``_pcg`` with the
tensor V-cycle, what ``tpfa_mg_pcg`` runs off the card), and the kernels'
launches a trip.  Transmissibilities and right-hand sides are seeded random
(the times do not depend on the values).
"""

from __future__ import annotations

import argparse

import torch

import chip_smoke
from darsia_tpu_torch.measure import beckmann_kernels as bk
from darsia_tpu_torch.utils import tracing


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--shape", type=int, nargs=2, default=(120, 280))
    args = parser.parse_args()
    device = torch.device("cuda:0")
    B, shape = args.batch, tuple(args.shape)
    print(f"{chip_smoke.card_line()}; B = {B}, {shape}")
    trans, rhs = chip_smoke.mg_problem(B, shape, device)
    levels = bk.tpfa_mg_levels(shape)
    h = bk.tpfa_mg_hierarchy(trans, 2, levels)
    x0 = torch.zeros_like(rhs)
    ker = bk.FusedMGPCG(h, B, shape, 2, 40, kernels=True)
    ref = bk.FusedMGPCG(h, B, shape, 2, 40, kernels=False)
    for s in (ker, ref):
        s.start(rhs, x0, 1e-6)
        s.act.fill_(1)
    ker.vcycle(1)
    rows = chip_smoke.cg_kernel_rows(bk, ker, ref, trans, levels)
    coarsest = ker.rc[-1].numel() * ker.rc[-1].element_size() * 2
    coarsest += 0 if h.coarse is None else h.coarse.numel() * 8
    rows.insert(-3, ("", f"coarsest {ker.shapes[-1]}", ker._coarsest, None, coarsest))
    total_ms = total_bound = 0.0
    for kernel, name, fn, plain, nbytes in rows:
        ms = chip_smoke.cuda_ms(fn, 20, device_paced=True)
        for s in (ker, ref):
            s.act.fill_(1)
        plain_ms = chip_smoke.cuda_ms(plain, 5) if plain is not None else float("nan")
        if kernel == "mg_coarse_matrix":
            plain_ms -= chip_smoke.cuda_ms(lambda: bk._mg_levels(trans, 2, levels, bk._OMEGA), 5)
        bound_ms = nbytes / chip_smoke.PEAK_BYTES_S * 1e3
        if kernel != "mg_coarse_matrix":  # once a solve, not a trip
            total_ms, total_bound = total_ms + ms, total_bound + bound_ms
        print(f"{name:>26}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_ms / ms:.0%}), "
              f"{nbytes / 1e6:.1f} MB, plain {plain_ms:.4f} ms")
    print(f"{'sum a trip':>26}: {total_ms:.4f} ms, bound {total_bound:.4f} ms "
          f"({total_bound / total_ms:.0%})")
    plain_vcycle = chip_smoke.cuda_ms(lambda: ref.vcycle(1), 5)
    print(f"{'plain V-cycle':>26}: {plain_vcycle:.4f} ms")

    tensor_ms = chip_smoke.cuda_ms(lambda: bk.tpfa_mg_hierarchy(trans, 2, levels), 5)
    build_ms = chip_smoke.cuda_ms(lambda: bk.mg_hierarchy_on_card(trans, levels), 5)
    start_ms = chip_smoke.cuda_ms(
        lambda: bk.FusedMGPCG(h, B, shape, 2, 40).start(rhs, x0, 1e-6), 5)
    print(f"per solve: hierarchy {build_ms:.3f} ms (tensor form {tensor_ms:.3f} ms), buffers "
          f"and start {start_ms:.3f} ms")
    fused = chip_smoke.trip_ms(lambda n: bk.mg_pcg_fused(h, rhs, x0, 0.0, n), 10, 30)
    counts = [tracing.counter("beckmann.mg_launches")]
    for n in (10, 30):
        bk.mg_pcg_fused(h, rhs, x0, 0.0, n)
        counts.append(tracing.counter("beckmann.mg_launches"))
    per_trip = ((counts[2] - counts[1]) - (counts[1] - counts[0])) / 20
    tensor = chip_smoke.trip_ms(
        lambda n: bk._pcg(
            lambda p: bk.tpfa_apply(p, h.trans[0], 2),
            lambda r: bk._project(bk._tpfa_vcycle(r, h, 2, 2, 40), 2),
            rhs, x0, 0.0, n, False, False, 2,
        ),
        3, 8,
    )
    print(f"trip: kernels {fused:.3f} ms ({per_trip:.1f} kernel launches a trip, plus the "
          f"coarsest product), tensor CG {tensor:.3f} ms: {tensor / fused:.2f}x")


if __name__ == "__main__":
    main()
