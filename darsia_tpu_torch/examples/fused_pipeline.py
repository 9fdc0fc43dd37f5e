"""The full per-image production path as one pipeline call.

The port of the JAX package's ``examples/fused_pipeline.py``:
``FusedAnalysisPipeline`` composes the correction chain (rigid translation
+ curvature), ``ImageRegistration`` and ``ConcentrationAnalysis``; with
``single_warp=True`` the correction field and the registration displacement
are composed, so correct + register costs one warp (two K1 launches on the
card), and a series runs frame by frame in one call.

The data is the JAX example's, fault included (reference fault 32): its
"uint8" base is the examples' float32 baseline in [0.35, 0.6], so the
probe's ``astype(np.int32)`` zeroes it outside the plume, the total mass is
0.0 and the registration's displacement is large.  It is kept, so that the
two packages can be compared line by line.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import (
    ConcentrationAnalysis,
    CurvatureCorrection,
    FusedAnalysisPipeline,
    H1_regularization,
    ImageRegistration,
    LinearModel,
    MonochromaticReduction,
    OpticalImage,
    TranslationCorrection,
)
from ..image.image import as_numpy, card_unless
from ..utils.linear_solvers import Jacobi
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the fused pipeline example")
    report = Report()
    shape = (135, 256) if fast else (270, 512)
    base_u8 = as_numpy(load_baseline(shape=shape, device=device).img)
    H, W = base_u8.shape[:2]

    # Correction chain: rigid translation + curvature (crop + bulge).
    curv = CurvatureCorrection(
        config={
            "crop": {
                "pts_src": [[2, 3], [H - 5, 2], [H - 4, W - 4], [2, W - 4]],
                "width": 2.8,
                "height": 1.5,
            },
            "bulge": {"horizontal_bulge": -1e-8, "vertical_bulge": -4e-7},
        }
    )
    trans = TranslationCorrection([1.0, -1.5])
    meta = {"width": 2.8, "height": 1.5}

    base = OpticalImage(base_u8, transformations=[trans, curv], device=device, **meta).img_as(
        torch.float32
    )
    analysis = ConcentrationAnalysis(
        base=base,
        signal_reduction=MonochromaticReduction(color="gray"),
        restoration=lambda s: H1_regularization(s, mu=1.0, omega=0.2, dim=2, solver=Jacobi(maxiter=10)),
        model=LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    registration = ImageRegistration(
        base, N_patches=[2, 4] if fast else [4, 8], rel_overlap=0.1, quality_tol=0.02
    )
    pipeline = FusedAnalysisPipeline(
        transformations=[trans, curv],
        registration=registration,
        analysis=analysis,
        single_warp=True,  # correct + register as one warp
    )

    # A probe frame: the baseline shifted by a rigid (2, 3)-pixel motion plus
    # a synthetic tracer plume.
    yy, xx = np.ogrid[:H, :W]
    plume = 40.0 * np.exp(-(((yy - H * 0.6) / (H * 0.09)) ** 2 + ((xx - W * 0.4) / (W * 0.08)) ** 2))
    probe = np.clip(
        np.roll(base_u8, shift=(2, 3), axis=(0, 1)).astype(np.int32) + plume[..., None], 0, 255
    ).astype(np.uint8)

    concentration = pipeline(probe, device=device)
    mass = float(concentration.img.sum())
    report("concentration:", tuple(concentration.shape), "total mass:", mass)

    # The registration object's introspection stays live after the call.
    disp = registration.displacement()
    max_disp = float(disp.abs().max())
    report("displacement field:", tuple(disp.shape), "max |disp| [m]:", max_disp)

    # Series: all frames in one call.
    T = 3
    series = np.stack([np.roll(probe, shift=(k, 0), axis=(0, 1)) for k in range(T)], axis=2)
    out = pipeline(OpticalImage(series, series=True, device=device, **meta))
    report("series concentration:", tuple(out.shape))
    return {"lines": report.lines, "total_mass": mass, "max_disp": max_disp}


if __name__ == "__main__":
    cli(main)
