"""Closed-loop generator of batched W1 solves: one client, one batch of pairs
per call, cycling a pool of seeded batches made on the device; each call
ends with the distances on the host.  The window holds whole batches and
ends at the batch boundary nearest to ``--seconds``.

Traffic keys (``workloads/<cell>.json``): ``pool_batches`` (distinct
batches in the pool), ``check_pairs`` (how many of the window's pairs are
kept for the comparison with the reference: one from each of that many
equal blocks of the batch index, see :class:`SpreadSample`),
``warm_iter`` (the Newton cap of the warm-up solve), ``trace_calls``
(how many batches ``--trace 1`` profiles after the window).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.common import Reservoir, free_device_memory, now, traced


def stratum(j: int, batch: int, strata: int):
    """The block of pair ``j`` when the batch index is cut into ``strata``
    equal blocks, or None where ``j``'s parity is not its block's (block
    ``s`` takes pairs of parity ``s % 2``).  A pick from every block finds a
    batch half left out whether the half is a run of blocks or every other
    pair."""
    s = min(j * strata // batch, strata - 1)
    return s if j % 2 == s % 2 else None


class SpreadSample:
    """One pair from each block of the batch index (:func:`stratum`), drawn
    uniformly from ``seed`` over all the window's batches."""

    def __init__(self, strata: int, batch: int, seed: int) -> None:
        self.batch, self.strata = batch, strata
        self.blocks = [Reservoir(1, seed * strata + s) for s in range(strata)]

    def offer(self, j: int, item) -> None:
        s = stratum(j, self.batch, self.strata)
        if s is not None:
            self.blocks[s].offer(item)

    @property
    def items(self) -> list:
        return [it for block in self.blocks for it in block.items]


def picks(batch: int, strata: int, seed: int) -> list:
    """One pair index from each block of one batch, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(strata):
        js = [j for j in range(batch) if stratum(j, batch, strata) == s]
        out.append(int(rng.choice(js)))
    return out


def run(cell, seed, seconds, trace, device, t0):
    cfg, tr = cell.config, cell.traffic
    B = cfg["batch"]
    parts = {"start": now() - t0}
    batches = cell.program.make_inputs(cfg, seed, device, tr["pool_batches"], B)
    parts["inputs"] = now() - t0
    solve = cell.program.build(cfg)
    parts["program"] = now() - t0
    # Warm-up: the same grid and batch through a solver capped at a few
    # Newton iterations, which launches every kernel the window's solves do.
    capped = dict(cfg, options=dict(cfg["options"], num_iter=int(tr["warm_iter"])))
    warm_solve = cell.program.build(capped)
    tic = now()
    warm_solve(*batches[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm_s = now() - tic
    del warm_solve
    setup_s = now() - t0
    parts["warm-up"] = setup_s
    samples = SpreadSample(tr["check_pairs"], B, seed)
    newton_max, batch_s = [], []
    calls = pairs = 0
    t_start = now()
    deadline = t_start + float(seconds)
    last = None
    # Whole batches: the window ends at the batch boundary nearest to
    # ``seconds``, so that it overruns by half a batch at most.
    while calls == 0 or now() + 0.5 * last < deadline:
        b = calls % len(batches)
        tic = now()
        distances, iterations, statuses = solve(*batches[b])
        last = now() - tic
        batch_s.append(last)
        newton_max.append(int(np.max(iterations)))
        for j in range(len(distances)):
            samples.offer(j, (b, j, float(distances[j]), int(statuses[j])))
        pairs += len(distances)
        calls += 1
    window = now() - t_start
    rec = {
        "window_s": window,
        "calls": calls,
        "pairs": pairs,
        "attempted": pairs,
        "batch_newton_max": newton_max,
        "batch_s": batch_s,
        "warm_s": warm_s,
        "setup_s": setup_s,
        "setup_parts": parts,
    }
    if trace:

        def more(n):
            for k in range(n):
                solve(*batches[k % len(batches)])

        rec["trace"] = traced(tr["trace_calls"], more)
        rec["trace"]["batches"] = tr["trace_calls"]
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec["notes"] = [
        f"batch seconds: first {batch_s[0]:.3f}, median {statistics.median(batch_s):.3f}, "
        f"warm-up solve {warm_s:.3f}"
    ]
    del solve
    free_device_memory()
    host = [(s.cpu().numpy(), d.cpu().numpy()) for s, d in batches]
    tic = now()
    rec["check"] = compare(cell, host, samples.items)
    rec["check"]["seconds"] = now() - tic
    return rec


def compare(cell, host, kept, dtype=None):
    """Each kept pair's distance against the reference's, as the largest
    relative gap; a pair the solver stopped on a non-finite iterate fails."""
    limit = cell.config["limits"]["distance_rel_err"]
    ref = cell.reference.Beckmann(cell.config, dtype)
    worst, failed = 0.0, 0
    for b, j, dist, status in kept:
        want, _ = ref.distance(host[b][0][j], host[b][1][j])
        err = abs(dist - want) / abs(want) if status != 2 and math.isfinite(dist) else math.inf
        failed += int(not err <= limit)
        worst = max(worst, err)
    if not kept:
        worst, failed = math.inf, 1
    return {
        "correct": failed == 0,
        "failed": failed,
        "compared": len(kept),
        "numbers": {"distance_rel_err": (worst, limit)},
    }


def readings(cell, seed, device) -> dict:
    """The two readings a limit is set from, on one seeded batch at the
    cell's size: the largest relative gap between the program's distances of
    the pairs :func:`picks` draws and the reference's, and between the
    control's (the reference in bfloat16) and the reference's."""
    cfg, tr = cell.config, cell.traffic
    [(src, dst)] = cell.program.make_inputs(cfg, seed, device, 1, cfg["batch"])
    solve = cell.program.build(cfg)
    distances, _, statuses = solve(src, dst)
    del solve
    free_device_memory()
    s, d = src.cpu().numpy(), dst.cpu().numpy()
    ref = cell.reference.Beckmann(cfg)
    ctl = cell.reference.Beckmann(cfg, torch.bfloat16)
    prog = control = 0.0
    for j in picks(cfg["batch"], tr["check_pairs"], seed):
        want, _ = ref.distance(s[j], d[j])
        prog = max(prog, abs(float(distances[j]) - want) / want if statuses[j] != 2 else math.inf)
        control = max(control, abs(ctl.distance(s[j], d[j])[0] - want) / want)
    return {"distance_rel_err": {"program": prog, "control": control}}
