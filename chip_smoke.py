#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py                  # the check
    python3 chip_smoke.py --profile DIR    # also profile the frame into DIR

Drives ``darsia_tpu_torch`` only (no JAX, no OpenCV), from the root of a
checkout, in four phases; any failure raises and exits non-zero:

1. Build the two-pass warp kernel K1 (``darsia_tpu_torch/csrc/warp_rows_t.cu``,
   nvcc, sm_90a) and print the card's name and power limit.
2. K1 against its plain PyTorch version on the card, at the schedule-test
   shapes and both production passes of a 1788x3180 frame (D=120): max |diff|
   <= 1e-6; time both at the production passes.
3. The two-pass warp against the exact gather warp on the 4K curvature field
   of the bench configuration, interior [8:-8, 8:-8], within the bench gate
   (mean < 2e-3, p99.9 < 0.05, max < 0.45).
4. The production path ``FusedAnalysisPipeline`` (translation + curvature
   correction -> 8x16-patch registration -> concentration with 10 Jacobi
   sweeps) on a seeded synthetic 1788x3180 uint8 frame: 1 warm-up and 5 timed
   frames, exactly 4 K1 launches per frame, finite output of the corrected
   shape, the staged public objects (corrected Image -> ImageRegistration ->
   ConcentrationAnalysis) within mean |diff| <= 1e-3 (the bench's full-path
   gate), and the same frame with K1 swapped for its plain version within
   mean |diff| <= 1e-5.

The second-to-last line is a JSON object of per-kernel results; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
H, W = 1788, 3180  # the production frame (baseline.jpg's size)
D_REG = 120  # registration warp bound (FusedAnalysisPipeline default)
SCHEDULE_SHAPES = [(3, 64, 300, 7), (3, 130, 515, 40), (3, 96, 257, 121)]
CURVATURE = {
    "crop": {
        "pts_src": [[8, 11], [H - 33, 16], [H - 40, W - 15], [5, W - 15]],
        "width": 2.8,
        "height": 1.5,
    },
    "bulge": {
        "horizontal_bulge": -1e-9,
        "vertical_bulge": -2.7e-8,
        "vertical_center_offset": -31,
    },
}
META = {"width": 2.8, "height": 1.5}
# Height of the corrected frame: the crop keeps the 2.8 : 1.5 aspect ratio.
OH = min(H, int(W / (META["width"] / META["height"])))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rows_case(C, R, W_in, D, W_out=None, seed=0, device="cuda"):
    """(data, cols) with |cols - j| <= D on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    W_out = W_out or W_in
    data = torch.randn((C, R, W_in), generator=g, device=device)
    j = torch.arange(W_out, dtype=torch.float32, device=device)
    noise = torch.rand((R, W_out), generator=g, device=device) * (2 * D) - D
    return data, (j + noise).contiguous()


def phase_kernel(w2p) -> dict:
    """K1 vs its plain version; times at the two production passes."""
    # Production shapes: pass 1 (3, H, W) -> (3, W, H); pass 2 (3, W, H) ->
    # (3, OH, W).
    cases = [(*s, None) for s in SCHEDULE_SHAPES]
    cases += [(3, H, W, D_REG, W), (3, W, H, D_REG, OH)]
    max_err, bitwise = 0.0, True
    timed = {}
    for k, (C, R, W_in, D, W_out) in enumerate(cases):
        data, cols = rows_case(C, R, W_in, D, W_out, seed=k)
        out = w2p.warp_rows_t(data, cols, D)
        torch.cuda.synchronize()
        ref = w2p.warp_rows_t_reference(data, cols, D)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = bool(torch.equal(out, ref))
        print(f"K1 {(C, R, W_in, W_out or W_in)} D={D}: max|kernel-plain|={err} bitwise={same}")
        if not err <= 1e-6:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        max_err, bitwise = max(max_err, err), bitwise and same
        if W_out is not None:
            # plain, kernel, kernel, plain: drift on the card shows as a gap
            # between the two readings of one version.
            p1 = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, D), 10)
            k1 = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20)
            k2 = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20)
            p2 = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, D), 10)
            name = "pass1" if len(timed) == 0 else "pass2"
            timed[name] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2]}
            gbps = 4.0 * (C * R * W_in + R * W_out + C * R * W_out) / (min(k1, k2) * 1e6)
            print(
                f"K1 {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
                f"{gbps:.1f} GB/s by the 12 B/element count"
            )
        del data, cols, out, ref
    return {"max_abs_err": max_err, "bitwise": bitwise, **timed}


def smooth_image(device) -> torch.Tensor:
    """Photograph-like smooth RGB in [0, 1]: a few seeded low-frequency waves."""
    rng = np.random.default_rng(1)
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    chans = []
    for _ in range(3):
        acc = torch.zeros((H, W), device=device)
        for _ in range(6):
            wl = rng.uniform(40.0, 400.0)
            ang, ph = rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
            acc += torch.sin(2 * np.pi * (yy * np.sin(ang) + xx * np.cos(ang)) / wl + ph)
        chans.append((acc - acc.min()) / (acc.max() - acc.min()))
    return torch.stack(chans, dim=-1)


def phase_two_pass(dt, device) -> dict:
    from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

    field, _ = dt.CurvatureCorrection(config=CURVATURE).pullback_field((H, W), device)
    bound = float((field - identity_grid(tuple(field.shape[1:]), device)).abs().max())
    max_disp = int(np.ceil(bound)) + 1
    img = smooth_image(device)
    two = warp_backend(img, field, order=1, max_disp=max_disp, force="kernel")
    ref = warp_backend(img, field, order=1, force="gather")
    torch.cuda.synchronize()
    err = (two - ref)[8:-8, 8:-8].abs().cpu().numpy()
    gate = {
        "mean": float(err.mean()),
        "p999": float(np.percentile(err, 99.9)),
        "max": float(err.max()),
        "max_disp": max_disp,
    }
    print(f"two-pass vs gather on the 4K curvature field: {gate}")
    if not (gate["mean"] < 2e-3 and gate["p999"] < 0.05 and gate["max"] < 0.45):
        raise AssertionError(f"two-pass gate failed: {gate}")
    return gate


def phase_main_path(dt, w2p, device, card: str, profile) -> dict:
    rng = np.random.default_rng(0)
    base_u8 = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    probe_u8 = np.roll(base_u8, shift=(2, 3), axis=(0, 1))

    curv = dt.CurvatureCorrection(config=CURVATURE)
    trans = dt.TranslationCorrection([2.0, -3.0])
    tic = time.perf_counter()
    base_img = dt.OpticalImage(
        torch.from_numpy(base_u8).to(device), transformations=[trans, curv], **META
    ).img_as(torch.float32)
    analysis = dt.ConcentrationAnalysis(
        base=base_img,
        signal_reduction=dt.MonochromaticReduction(color="gray"),
        restoration=lambda s: dt.H1_regularization(
            s, mu=1.0, omega=0.2, dim=2, solver=dt.Jacobi(maxiter=10)
        ),
        model=dt.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    registration = dt.ImageRegistration(
        base_img, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02
    )
    pipeline = dt.FusedAnalysisPipeline(
        transformations=[trans, curv], registration=registration, analysis=analysis
    )
    probe = torch.from_numpy(probe_u8).to(device)
    out = pipeline(probe)  # warm-up: builds the setup products
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic

    frames = 5
    torch.cuda.reset_peak_memory_stats(device)
    w2p.launch_count = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(frames):
        out = pipeline(probe)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - tic
    launches = w2p.launch_count
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    if launches != 4 * frames:
        raise AssertionError(f"{launches} K1 launches in {frames} frames, want {4 * frames}")
    conc = out.img
    if tuple(conc.shape) != (OH, W) or not bool(torch.isfinite(conc).all()):
        raise AssertionError(f"bad concentration: shape {tuple(conc.shape)}")

    # The bench's full-path gate (bench.py:162-180): the same public objects
    # run as separate stages must give the same concentration.
    staged_img = dt.OpticalImage(probe, transformations=[trans, curv], **META)
    staged = analysis(registration(staged_img.img_as(torch.float32))).img
    staged_err = float((staged - conc).abs().mean())
    if not staged_err <= 1e-3:
        raise AssertionError(f"staged vs fused path: mean |dconc| = {staged_err}")

    before = w2p.launch_count
    plain = pipeline(probe, warp_impl="plain").img
    torch.cuda.synchronize()
    if w2p.launch_count != before:
        raise AssertionError("the plain run launched K1")
    diff = float((plain - conc).abs().mean())
    if not diff <= 1e-5:
        raise AssertionError(f"kernel vs plain frame: mean |dconc| = {diff}")
    tic = time.perf_counter()
    for _ in range(frames):
        pipeline(probe, warp_impl="plain")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tic) / frames * 1e3

    ms = elapsed / frames * 1e3
    mpix = H * W / 1e6 / (elapsed / frames)
    result = {
        "ms_per_frame": ms,
        "mpix_s": mpix,
        "plain_k1_ms_per_frame": plain_ms,
        "launches": launches,
        "frames": frames,
        "setup_s": setup_s,
        "peak_gib": peak_gib,
        "mean_abs_dconc_plain": diff,
        "mean_abs_dconc_staged": staged_err,
        "conc_mean": float(conc.mean()),
    }
    print(
        f"main path: {ms:.3f} ms/frame, {mpix:.2f} Mpix/s ({H}x{W} uint8 in, "
        f"{frames} frames, {launches} K1 launches) on {card}; with plain K1 "
        f"{plain_ms:.3f} ms/frame; mean|dconc| vs plain K1 {diff}, vs staged objects "
        f"{staged_err}; peak {peak_gib:.2f} GiB; "
        f"setup + warm-up {setup_s:.2f} s"
    )
    if profile is not None:
        profile_frame(pipeline, probe, ms, profile)
        stage_times(pipeline, probe)
    return result


def profile_frame(pipeline, probe, ms_per_frame: float, out_dir: Path, frames: int = 3):
    """torch.profiler over a few frames: kernel table and Chrome trace into
    ``out_dir``, device busy time and idle share printed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        for _ in range(frames):
            pipeline(probe)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_frame.txt").write_text(table)
    trace = out_dir / "profile_frame.json"
    prof.export_chrome_trace(str(trace))
    print(table)
    # Device busy time: the union of kernel/memcpy/memset intervals.
    events = [
        e
        for e in json.loads(trace.read_text())["traceEvents"]
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    ]
    events.sort(key=lambda e: e["ts"])
    busy, cur_start, cur_end = 0.0, None, None
    for e in events:
        start, end = e["ts"], e["ts"] + e["dur"]
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    busy_ms = busy / 1e3 / frames
    print(
        f"profile: {len(events) / frames:.0f} device ops per frame, device busy "
        f"{busy_ms:.3f} ms per frame; idle share against the unprofiled "
        f"{ms_per_frame:.3f} ms/frame: {1 - busy_ms / ms_per_frame:.3f}"
    )


def stage_times(pipeline, probe, reps: int = 10) -> None:
    """Stream time of each stage of the frame, run back to back (CUDA events)."""
    from darsia_tpu_torch.analysis.translationanalysis import _to_gray
    from darsia_tpu_torch.utils.dtype import convert_dtype

    stages, _ = pipeline._stage_plan(tuple(probe.shape[:2]), probe.device)
    ((_, chain),) = stages
    apply = chain.apply_fn(probe.dtype)
    ta = pipeline._translation_analysis
    estimate, reg_ops, _ = ta.fused_estimator_parts(pipeline.max_disp)
    aligner, _ = ta.fused_aligner_parts(pipeline.max_disp)
    conc_fn = pipeline.analysis.pipeline_fn()
    base = pipeline.analysis.base.img
    corrected = apply(probe, chain.field)
    x = convert_dtype(corrected, torch.float32)
    registered = aligner(x, reg_ops)[0]
    times = {
        "correction warp (2 K1 + mask + round)": lambda: apply(probe, chain.field),
        "u8 -> f32": lambda: convert_dtype(corrected, torch.float32),
        "registration estimate (gray, windows, FFT, TPS)": lambda: estimate(
            _to_gray(x), reg_ops
        ),
        "registration total (+ upsample, 2 K1 warp)": lambda: aligner(x, reg_ops),
        "concentration (diff, gray, model, 10 Jacobi)": lambda: conc_fn(registered, base),
    }
    for name, fn in times.items():
        print(f"stage {name}: {cuda_ms(fn, reps):.3f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile",
        type=Path,
        metavar="DIR",
        help="also profile 3 frames (table + Chrome trace into DIR) and time the stages",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a card")
    sys.path.insert(0, str(REPO))
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.ops import warp2pass as w2p

    device = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    card = card_line()
    print(card)

    tic = time.perf_counter()
    w2p.build_kernel()
    build_s = time.perf_counter() - tic
    print(f"K1 build + load: {build_s:.2f} s")
    if w2p.build_info is not None:
        for line in w2p.build_info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("ptxas:", line.strip())

    k1 = phase_kernel(w2p)
    phase_two_pass(dt, device)
    main = phase_main_path(dt, w2p, device, card, args.profile)

    ms = sum(min(k1[p]["kernel_ms"]) for p in ("pass1", "pass2"))
    plain_ms = sum(min(k1[p]["plain_ms"]) for p in ("pass1", "pass2"))
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "warp_rows_t",
                        "route": "cuda",
                        "source": "darsia_tpu_torch/csrc/warp_rows_t.cu",
                        "replaces": "darsia_tpu/ops/pallas/warp2pass.py:323",
                        "launches": main["launches"],
                        "max_abs_err": k1["max_abs_err"],
                        "ms": ms,
                        "plain_ms": plain_ms,
                    }
                ]
            }
        )
    )
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
