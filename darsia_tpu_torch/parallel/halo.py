"""Halo exchange for sharded stencils.

Counterpart of :mod:`darsia_tpu.parallel.halo`.  A stencil on an image
split over a mesh axis needs ``halo`` rows of each neighbour shard; they
arrive through :func:`~darsia_tpu_torch.parallel.collectives.shift`.  At the
global boundary the shard pads itself by edge replication (the Neumann
closure of the single-device stencils).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .collectives import shift

__all__ = ["halo_exchange", "halo_exchange_2d"]


def halo_exchange(line: Sequence[torch.Tensor], halo: int, axis: int = 0) -> list:
    """Pad each shard of a line with ``halo`` slabs of its neighbours.

    Args:
        line: the shards along one mesh axis, in order.
        halo: number of slabs to exchange.
        axis: tensor axis that the mesh axis splits.

    Returns:
        The shards extended by ``halo`` on both sides of ``axis``.

    """
    num = len(line)
    n = line[0].shape[axis]
    # My bottom slabs become the next shard's top halo, my top slabs the
    # previous shard's bottom halo (rings, as lax.ppermute's).
    from_above = shift([x.narrow(axis, n - halo, halo) for x in line], 1)
    from_below = shift([x.narrow(axis, 0, halo) for x in line], -1)
    out = []
    for i, local in enumerate(line):
        reps = [1] * local.dim()
        reps[axis] = halo
        top = local.narrow(axis, 0, 1).repeat(reps) if i == 0 else from_above[i]
        bottom = local.narrow(axis, n - 1, 1).repeat(reps) if i == num - 1 else from_below[i]
        out.append(torch.cat([top, local, bottom], dim=axis))
    return out


def halo_exchange_2d(grid: Sequence[Sequence[torch.Tensor]], halo: int, axes: tuple = (0, 1)) -> list:
    """Corner-correct halo exchange over a (rows, cols) mesh.

    ``grid[i][j]`` is the shard at mesh position (i, j).  The row exchange
    runs first; the column exchange then ships blocks already extended by
    it, so corner halos arrive from the diagonal neighbour through the row
    neighbour.  Outer boundaries are edge-replicated as in
    :func:`halo_exchange`.
    """
    pr, pc = len(grid), len(grid[0])
    cols = [halo_exchange([grid[i][j] for i in range(pr)], halo, axes[0]) for j in range(pc)]
    return [halo_exchange([cols[j][i] for j in range(pc)], halo, axes[1]) for i in range(pr)]
