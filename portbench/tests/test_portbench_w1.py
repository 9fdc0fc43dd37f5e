"""The W1 cell's builder against its plain reference, and the comparison
against its control and planted faults, on a 30 x 70 grid on the CPU; on a
card, the readings at the cell's own size."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from conftest import tiny_w1

from portbench import harness

SEED = 2**31 + 91


@pytest.fixture
def cell():
    c = harness.find_cell("w1ff.allpairs")
    c.config = tiny_w1(c.config)
    return c


def test_maps_have_unit_mass_and_repeat_for_a_seed(cell):
    dev = torch.device("cpu")
    [(s1, d1)] = cell.program.make_inputs(cell.config, SEED, dev, 1, 3)
    [(s2, _)] = cell.program.make_inputs(cell.config, SEED, dev, 1, 3)
    [(s3, _)] = cell.program.make_inputs(cell.config, SEED + 1, dev, 1, 3)
    mass = (s1.sum(dim=(1, 2)) * cell.config["voxel_size"] ** 2).numpy()
    assert np.allclose(mass, 1.0, atol=1e-5) and s1.shape == (3, 30, 70)
    assert torch.equal(s1, s2) and not torch.equal(s1, s3) and not torch.equal(s1, d1)


def test_builder_reference_and_control(cell):
    [(src, dst)] = cell.program.make_inputs(cell.config, SEED, torch.device("cpu"), 1, 3)
    distances, iterations, statuses = cell.program.build(cell.config)(src, dst)
    limit = cell.config["limits"]["distance_rel_err"]
    ref = cell.reference.Beckmann(cell.config)
    ctl = cell.reference.Beckmann(cell.config, torch.bfloat16)
    worst_ctl = 0.0
    for j in range(3):
        want, its = ref.distance(src[j].numpy(), dst[j].numpy())
        assert statuses[j] == 1 and abs(int(iterations[j]) - its) <= 1
        assert abs(distances[j] - want) / want <= limit / 10
        worst_ctl = max(worst_ctl, abs(ctl.distance(src[j].numpy(), dst[j].numpy())[0] - want) / want)
    assert worst_ctl > 3 * limit


def _run(cell):
    rec = harness.run_cell(cell, SEED, 0.1, False, torch.device("cpu"), time.perf_counter())
    return harness.result_line(cell, rec, False)


def test_a_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] and line["attempted"] >= 3
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}


def _broken(solve, fault):
    def run(src, dst):
        if fault == "unchanged":
            # The Newton loop returns its state unchanged: the Darcy start.
            d, k, s = solve(src, dst, num_iter=0)
            return d, k, np.ones_like(s)
        d, k, s = solve(src, dst)
        d = d.copy()
        if fault == "half":
            # Half of the batch left out, the mean of the rest in its place.
            d[len(d) // 2 :] = d[: len(d) // 2].mean()
        elif fault == "altered":
            d[0] *= 1.01
        return d, k, s

    return run


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(cell, monkeypatch, fault):
    from darsia_tpu_torch.parallel import batched_wasserstein

    def solve(src, dst, num_iter=None):
        opts = dict(cell.config["options"])
        if num_iter is not None:
            opts["num_iter"] = num_iter
        return batched_wasserstein(tuple(cell.config["grid_shape"]), cell.config["voxel_size"], options=opts)(src, dst)

    build = cell.program.build
    # The warm-up's capped solver stays sound; the window's solver is broken.
    monkeypatch.setattr(
        cell.program,
        "build",
        lambda cfg: build(cfg) if cfg["options"]["num_iter"] != cell.config["options"]["num_iter"]
        else _broken(solve, fault),
    )
    assert not _run(cell)["correct"]


def _halves(batch):
    """The ways a half of the batch is left out: either run of half the
    pairs, the middle half, the even and the odd pairs."""
    h, q = batch // 2, batch // 4
    return [range(h), range(h, batch), range(q, q + h), range(0, batch, 2), range(1, batch, 2)]


@pytest.mark.parametrize("batch", [8, 256, 1024])
def test_the_sample_always_holds_a_pair_of_each_half(batch):
    cell = harness.find_cell("w1ff.allpairs")
    w1, strata = cell.generator, cell.traffic["check_pairs"]
    for seed in range(40):
        sample = w1.SpreadSample(strata, batch, seed)
        for j in range(batch):
            sample.offer(j, j)
        for kept in (sample.items, w1.picks(batch, strata, seed)):
            assert len(kept) == strata
            for half in _halves(batch):
                assert any(j in half for j in kept) and any(j not in half for j in kept)


@pytest.mark.gpu
def test_readings_on_the_card(cuda_device):
    c = harness.find_cell("w1ff.allpairs")
    limit = c.config["limits"]["distance_rel_err"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = c.generator.readings(c, seed, cuda_device)["distance_rel_err"]
        print(json.dumps({"workload": c.name, "seed": seed, "distance_rel_err": r}))
        assert r["program"] <= limit < r["control"]
