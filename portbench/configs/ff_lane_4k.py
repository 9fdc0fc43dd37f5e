"""Configuration ``ff_lane_4k``: its inputs made from the seed, and the
port's two-warp lane built from the configuration's numbers.

The inputs are made on the device from one ``torch.Generator`` in a few
large calls: a uniform uint8 noise frame as the baseline, and each frame of
a series the baseline rolled by ``(2 + k, 3)`` with a CO2 plume of its own
painted in, which grows with the frame index ``k``.  Every seed gives the
same sizes; the seed moves the noise and the plumes.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def make_baseline(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    fr = cfg["frame"]
    shape = (fr["height"], fr["width"], fr["channels"])
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def make_series(cfg: dict, base: torch.Tensor, gen: torch.Generator, length: int) -> torch.Tensor:
    """(H, W, length, C) uint8: frame k is the baseline rolled by (2 + k, 3)
    plus a seeded plume that grows with k."""
    H, W = base.shape[:2]
    p = cfg["plume"]
    dev = base.device
    u = torch.rand(4, generator=gen, device=dev, dtype=torch.float64).tolist()

    def lerp(lim, t):
        return lim[0] + t * (lim[1] - lim[0])

    cy = lerp(p["center_rows"], u[0]) * H
    cx = lerp(p["center_cols"], u[1]) * W
    ry0, rx0 = lerp(p["radius_rows"], u[2]), lerp(p["radius_cols"], u[3])
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    frames = []
    for k in range(length):
        grow = 1.0 + p["growth"] * k
        blob = p["amplitude"] * torch.exp(
            -(((yy - cy) / (ry0 * grow)) ** 2 + ((xx - cx) / (rx0 * grow)) ** 2)
        )
        rolled = torch.roll(base, shifts=(2 + k, 3), dims=(0, 1)).to(torch.float32)
        frames.append((rolled + blob[..., None]).clamp(0, 255).to(torch.uint8))
    return torch.stack(frames, dim=2)


def make_inputs(cfg: dict, seed: int, device, n_series: int, length: int):
    """``(baseline (H, W, C), [series (H, W, length, C)] * n_series)``, all
    uint8 on ``device``."""
    gen = generator(seed, device)
    base = make_baseline(cfg, gen, device)
    return base, [make_series(cfg, base, gen, length) for _ in range(n_series)]


def build(cfg: dict, base_u8: torch.Tensor):
    """The port's ``FusedAnalysisPipeline`` for this configuration, set up on
    the baseline's device from the raw baseline frame."""
    import darsia_tpu_torch as dt

    curv = cfg["curvature"]
    reg = cfg["registration"]
    conc = cfg["concentration"]
    meta = cfg["metadata"]
    curvature = dt.CurvatureCorrection(config={"crop": curv["crop"], "bulge": curv["bulge"]})
    translation = dt.TranslationCorrection(list(cfg["translation"]))
    chain = [translation, curvature]
    base = dt.OpticalImage(base_u8, transformations=chain, **meta).img_as(torch.float32)
    mu, omega, sweeps = conc["mu"], conc["omega"], conc["jacobi_maxiter"]
    analysis = dt.ConcentrationAnalysis(
        base=base,
        signal_reduction=dt.MonochromaticReduction(color=conc["color"]),
        restoration=lambda s: dt.H1_regularization(
            s, mu=mu, omega=omega, dim=2, solver=dt.Jacobi(maxiter=sweeps)
        ),
        model=dt.LinearModel(scaling=conc["scaling"]),
        **{"diff option": conc["diff"]},
    )
    registration = dt.ImageRegistration(
        base,
        N_patches=list(reg["N_patches"]),
        rel_overlap=reg["rel_overlap"],
        quality_tol=reg["quality_tol"],
    )
    return dt.FusedAnalysisPipeline(
        transformations=chain,
        registration=registration,
        analysis=analysis,
        max_disp=reg["max_disp"],
        single_warp=cfg["lane"] == "single_warp",
    )
