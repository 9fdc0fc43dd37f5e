"""Configuration ``ff_w1_maps``: batches of FluidFlower-sized concentration
maps made from the seed, and the port's batched W1 solve.

A map is a CO2 plume under a sealing interface: a gravity current spread
under a gently curved interface, fed by a rising column from an injection
point below it, plus ``noise`` U(0, 1) everywhere, as the JAX package's
benchmark adds; each map is normalised to unit mass.

The plumes' shapes are a fixed quasi-random set (the R_d sequence over the
configuration's ranges), the same for every seed, so that every seed asks
the solver for the same work: the seed orders the pairs of each batch and
draws the noise.  All of a pool's maps are made on the device in a few
batched calls.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def shape_parameters(first: int, count: int, device) -> torch.Tensor:
    """(7, count, 1, 1) points of the R_d sequence in [0, 1)^7 (Roberts'
    generalised golden ratio), entries ``first`` to ``first + count``."""
    phi = 2.0
    for _ in range(64):
        phi = (1.0 + phi) ** (1.0 / 8.0)
    alpha = torch.tensor([phi ** -(k + 1) for k in range(7)], dtype=torch.float64)
    n = torch.arange(first, first + count, dtype=torch.float64)
    u = torch.remainder(0.5 + alpha[:, None] * n[None, :], 1.0)
    return u.to(device=device, dtype=torch.float32).reshape(7, count, 1, 1)


def make_maps(cfg: dict, gen: torch.Generator, u: torch.Tensor, device) -> torch.Tensor:
    """(count, H, W) float32 maps of unit mass (sum times the cell area) for
    the (7, count, 1, 1) shape parameters ``u``."""
    H, W = cfg["grid_shape"]
    m = cfg["maps"]
    count = u.shape[1]
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None] / H
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :] / W

    def span(lim, t):
        return lim[0] + t * (lim[1] - lim[0])

    # The interface: its depth at x, a tilt and one gentle bend.
    depth = span(m["interface_depth"], u[0]) + 0.05 * (u[1] - 0.5) * torch.sin(
        math.pi * (xx + u[2])
    )
    x0 = span(m["injection_x"], u[3])
    spread = span(m["current_width"], u[4])
    thick = span(m["current_thickness"], u[5])
    column = span(m["column_width"], u[6])
    below = (yy - depth).clamp(min=0.0)
    current = torch.exp(-(((xx - x0) / spread) ** 2) - (below / thick) ** 2) * (yy >= depth)
    rising = torch.exp(-(((xx - x0) / column) ** 2)) * (yy >= depth) * (yy <= depth + 0.5)
    maps = current + 0.3 * rising
    maps = maps + m["noise"] * torch.rand((count, H, W), generator=gen, device=device)
    cell = float(cfg["voxel_size"]) ** 2
    return maps / (maps.sum(dim=(1, 2), keepdim=True) * cell)


def make_inputs(cfg: dict, seed: int, device, n_batches: int, batch: int):
    """``[(src (B, H, W), dst (B, H, W))] * n_batches`` on ``device``: each
    batch the configuration's ``batch`` pairs of plume shapes, in an order
    and with noise drawn from the seed."""
    gen = generator(seed, device)
    src_u = shape_parameters(0, batch, device)
    dst_u = shape_parameters(batch, batch, device)
    out = []
    for _ in range(n_batches):
        order = torch.randperm(batch, generator=gen, device=device)
        out.append(
            (make_maps(cfg, gen, src_u[:, order], device), make_maps(cfg, gen, dst_u[:, order], device))
        )
    return out


def build(cfg: dict):
    """``solve(src, dst) -> (distances, iterations, statuses)``, the port's
    batched Newton solve for this grid and these options."""
    from darsia_tpu_torch.parallel import batched_wasserstein

    return batched_wasserstein(
        tuple(cfg["grid_shape"]), voxel_size=cfg["voxel_size"], options=dict(cfg["options"])
    )
