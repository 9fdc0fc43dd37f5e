"""Domain-decomposed Wasserstein-1 on a device mesh.

The port of the JAX package's ``examples/sharded_wasserstein.py``: one mass
image's rows are split over an 8-shard mesh (``parallel/mesh.py``) and the
Newton iteration runs shard by shard with halo exchanges and reductions,
then the single-device solve is the reference.  The mesh names ``device``
8 times (``cpu`` x 8 on the CPU, ``cuda:0`` x 8 on one card), as a mesh of
8 devices is what the JAX example builds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import Image, L1Mode, MobilityMode, wasserstein_distance
from ..image.image import card_unless
from ..parallel import create_mesh
from . import Report, cli

SHARDS = 8


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the sharded Wasserstein example")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    report = Report()
    n = 32 if fast else 64
    src = np.zeros((n, n))
    src[4 : n // 3, 4 : n // 3] = 1
    dst = np.zeros((n, n))
    dst[n // 2 :, n // 2 :] = 1
    meta = {"width": 1.0, "height": 1.0, "scalar": True}
    src_img = Image(src / src.sum() * n * n, device=device, **meta)
    dst_img = Image(dst / dst.sum() * n * n, device=device, **meta)

    mesh = create_mesh((SHARDS,), ("space",), devices=[device] * SHARDS)
    distance, info = wasserstein_distance(
        src_img,
        dst_img,
        method="sharded_newton",
        options={
            "mesh": mesh,
            "num_iter": 300,
            "tol_increment": 1e-4,
            "tol_distance": 1e-4,
            "aa_depth": 5,
            "return_info": True,
        },
    )
    iterations = info["number_iterations"]
    report(f"sharded W1 over {SHARDS} devices: {distance:.6f} ({iterations} Newton iterations)")

    reference = float(
        wasserstein_distance(
            src_img,
            dst_img,
            method="newton",
            options={
                "num_iter": 300,
                "tol_increment": 1e-4,
                "tol_distance": 1e-4,
                "mobility_mode": MobilityMode("cell_based"),
                "l1_mode": L1Mode("constant_cell_projection"),
                "L": 1e9,
                "aa_depth": 5,
            },
        )
    )
    rel = abs(distance - reference) / reference
    report(f"single-device W1: {reference:.6f} (rel diff {rel:.2e})")
    if not rel < 1e-3:
        raise RuntimeError(f"sharded W1 {distance} and single-device W1 {reference} differ by {rel:.2e}")
    return {"lines": report.lines, "distance": distance, "reference": reference, "iterations": iterations}


if __name__ == "__main__":
    cli(main)
