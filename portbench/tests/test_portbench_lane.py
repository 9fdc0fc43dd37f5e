"""The lane's builder against its plain reference, and the comparison that
decides ``correct`` against its control and planted faults, at a tiny size
on the CPU; on a card, the readings at the cell's own size."""

from __future__ import annotations

import json
import time

import pytest
import torch
from conftest import tiny_lane

from portbench import harness

SEED = 2**31 + 77


@pytest.fixture
def cell():
    c = harness.find_cell("lane4k.series8")
    c.config = tiny_lane(c.config)
    return c


def _program_and_reference(cell, dtype=torch.float32):
    base, series = cell.program.make_inputs(cell.config, SEED, torch.device("cpu"), 1, 4)
    got = cell.program.build(cell.config, base)(series[0]).img
    lane = cell.reference.Lane(cell.config, base, dtype=dtype)
    return [(got[..., k], lane(series[0][:, :, k])) for k in range(series[0].shape[2])]


def test_inputs_repeat_for_a_seed_and_move_with_it(cell):
    dev = torch.device("cpu")
    a = cell.program.make_inputs(cell.config, SEED, dev, 2, 3)
    b = cell.program.make_inputs(cell.config, SEED, dev, 2, 3)
    c = cell.program.make_inputs(cell.config, SEED + 1, dev, 2, 3)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert not torch.equal(a[0], c[0])
    assert a[1][0].shape == (120, 208, 3, 3) and a[1][0].dtype == torch.uint8


def test_builder_and_reference_agree_on_the_cpu(cell):
    limit = cell.config["limits"]["conc_max_abs_err"]
    pairs = _program_and_reference(cell)
    assert pairs[0][0].abs().max() > 0.05  # the plume shows
    for got, want in pairs:
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= limit / 100


def test_builder_and_reference_agree_on_the_cards_warp(cell, monkeypatch):
    """The card's bilinear warps are the two-pass resample (K1 twice); on
    the CPU the port takes the gather warp.  Forcing the port onto its plain
    two-pass path and the reference onto its own reproduces the card's
    arithmetic here."""
    import darsia_tpu_torch.analysis.translationanalysis as ta
    import darsia_tpu_torch.corrections.fuse as fuse
    import darsia_tpu_torch.corrections.shape.curvature as curvature
    import darsia_tpu_torch.corrections.shape.quad as quad
    from darsia_tpu_torch.ops import warp as warp_mod

    original = warp_mod.warp_backend

    def two_pass(data, coords, order=1, mode="constant", cval=0.0, max_disp=None, **kw):
        if order == 1 and coords.shape[0] == 2 and data.dim() in (2, 3):
            if max_disp is None:
                max_disp = cell.reference.disp_bound(coords)
            if max_disp <= cell.reference.MAX_TWO_PASS_DISP:
                return original(data, coords, order, mode, cval, max_disp, force="kernel")
        return original(data, coords, order, mode, cval, max_disp)

    for mod in (ta, fuse, curvature, quad):
        monkeypatch.setattr(mod, "warp_backend", two_pass)
    monkeypatch.setattr(cell.reference, "bilinear", _card_bilinear(cell.reference))
    limit = cell.config["limits"]["conc_max_abs_err"]
    for got, want in _program_and_reference(cell):
        assert float((got - want).abs().max()) <= limit / 100


def _card_bilinear(ref):
    def bilinear(data, coords, two_pass, max_disp=None):
        return ref.two_pass_warp(data, coords, ref.disp_bound(coords) if max_disp is None else max_disp)

    return bilinear


def test_control_fails_the_limit(cell):
    limit = cell.config["limits"]["conc_max_abs_err"]
    worst = 0.0
    for got, want in _program_and_reference(cell, dtype=torch.bfloat16):
        worst = max(worst, float((got - want).abs().max()))
    assert worst > 3 * limit


def _run(cell, name, seconds=1.5):
    c = harness.find_cell(name)
    c.config = cell.config
    c.modules = cell.modules
    rec = harness.run_cell(c, SEED, seconds, False, torch.device("cpu"), time.perf_counter())
    return c, rec


@pytest.mark.parametrize("name", ["lane4k.series8", "lane4k.live"])
def test_a_sound_run_is_correct(cell, name):
    c, rec = _run(cell, name)
    line = harness.result_line(c, rec, False)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(line)[-1] == "compared"


class _Broken:
    """The program with one fault planted where its answer is produced."""

    def __init__(self, pipeline, fault):
        self.pipeline, self.fault, self.last = pipeline, fault, None

    def __call__(self, x):
        out = self.pipeline(x)
        conc = out.img
        if self.fault == "stale":
            # A step that returns its state unchanged: the previous answer.
            previous, self.last = self.last, conc.clone()
            if previous is not None:
                out.img = previous
        elif self.fault == "half":
            # Half of the batch left out, the mean of the rest in its place.
            if conc.dim() == 3:
                half = conc.shape[-1] // 2
                conc[..., half:] = conc[..., :half].mean(dim=-1, keepdim=True)
            else:
                conc[conc.shape[0] // 2 :] = conc[: conc.shape[0] // 2].mean()
        elif self.fault == "altered":
            conc[conc.shape[0] // 2, conc.shape[1] // 2] += 0.01
        return out


@pytest.mark.parametrize("name", ["lane4k.series8", "lane4k.live"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_planted_fault_is_not_correct(cell, monkeypatch, name, fault):
    build = cell.program.build
    monkeypatch.setattr(cell.program, "build", lambda cfg, base: _Broken(build(cfg, base), fault))
    c, rec = _run(cell, name)
    assert not rec["check"]["correct"]
    assert not harness.result_line(c, rec, False)["correct"]


@pytest.mark.gpu
def test_readings_on_the_card(cuda_device):
    """The cell's own size: the program within the limit on three seeds,
    the control above it."""
    c = harness.find_cell("lane4k.series8")
    limit = c.config["limits"]["conc_max_abs_err"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = c.generator.readings(c, seed, cuda_device)["conc_max_abs_err"]
        print(json.dumps({"workload": c.name, "seed": seed, "conc_max_abs_err": r}))
        assert r["program"] <= limit < r["control"]
