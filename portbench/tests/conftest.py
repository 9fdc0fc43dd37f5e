"""Shared fixtures of the benchmark's own tests: the repository on the
import path, tiny variants of the configurations, and the card check."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_lane(cfg: dict) -> dict:
    """The lane at 120 x 208 with a 2 x 4 patch grid, the crop and bulge
    scaled to it."""
    cfg = copy.deepcopy(cfg)
    H, W = 120, 208
    cfg["frame"].update(height=H, width=W)
    cfg["curvature"]["crop"]["pts_src"] = [[1, 1], [H - 3, 2], [H - 4, W - 2], [1, W - 2]]
    cfg["curvature"]["bulge"] = {
        "horizontal_bulge": -1e-7,
        "vertical_bulge": -2e-6,
        "vertical_center_offset": -3,
    }
    cfg["registration"]["N_patches"] = [2, 4]
    cfg["plume"]["radius_rows"] = [6.0, 10.0]
    cfg["plume"]["radius_cols"] = [10.0, 16.0]
    return cfg


def tiny_w1(cfg: dict) -> dict:
    """W1 on a 30 x 70 grid, eight pairs per batch."""
    cfg = copy.deepcopy(cfg)
    cfg["grid_shape"] = [30, 70]
    cfg["batch"] = 8
    return cfg


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
