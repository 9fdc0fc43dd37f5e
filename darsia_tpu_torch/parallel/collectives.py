"""Where shards meet: the collectives of one mesh axis.

The port's counterpart of the ``lax`` collectives that the JAX package's
``shard_map`` bodies call.  Each function takes a *line* of values, one per
position along a mesh axis, each a tensor on its position's device, and
returns one value per position on that position's device:

* :func:`shift` (``lax.ppermute`` around the ring): a copy to the
  neighbour's device;
* :func:`psum`, :func:`pmax`: the partial results brought to the line's
  first device, reduced there in position order, and sent back;
* :func:`all_gather` (``tiled=True``): the same with a concatenation;
* :func:`broadcast`: a value on the line's first device sent to every
  position;
* :func:`psum_totals`: the psum of each position's total of one or more
  lines (CG dot products and projections), the positions that share a
  device totalled in one reduction.

:func:`psum_totals`'s ``then`` maps the reduced value once, on the first
device, before it is sent back: the replicated scalar arithmetic that
follows a ``psum`` in the JAX package's bodies (every shard computes the
same value) is done once per line.

Nothing here reads a value on the host, and nothing else in the package
moves data between shards.  Where positions share a device, the copy is no
copy and every position holds the same result tensor: callers treat results
as read-only.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

__all__ = ["all_gather", "broadcast", "device_groups", "pmax", "psum", "psum_totals", "shift"]


def _to(value: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``value`` on ``device``: itself where it lies there already."""
    return value if value.device == device else value.to(device, non_blocking=True)


def shift(values: Sequence[torch.Tensor], step: int) -> list:
    """Ring permutation: position ``i`` receives ``values[(i - step) % n]``
    (``step=1`` sends each value to the next position, ``-1`` to the
    previous one)."""
    n = len(values)
    return [_to(values[(i - step) % n], values[i].device) for i in range(n)]


def _gathered(values: Sequence[torch.Tensor]) -> list:
    first = values[0].device
    return [_to(v, first) for v in values]


def broadcast(value: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """``value`` on the device of each of ``like``'s positions."""
    return [_to(value, x.device) for x in like]


def psum(values: Sequence[torch.Tensor]) -> list:
    """Sum over the line (equal shapes), on every position."""
    return broadcast(torch.stack(_gathered(values)).sum(dim=0), values)


def pmax(values: Sequence[torch.Tensor]) -> list:
    """Maximum over the line (equal shapes), on every position."""
    return broadcast(torch.stack(_gathered(values)).amax(dim=0), values)


def all_gather(values: Sequence[torch.Tensor], dim: int = 0) -> list:
    """Concatenation of the line along ``dim``, on every position."""
    return broadcast(torch.cat(_gathered(values), dim=dim), values)


def device_groups(values: Sequence[torch.Tensor]) -> list:
    """The positions of a line grouped by device, each group in position
    order."""
    groups: dict = {}
    for i, v in enumerate(values):
        groups.setdefault(v.device, []).append(i)
    return list(groups.values())


def psum_totals(lines: Sequence[Sequence[torch.Tensor]], then: Optional[Callable] = None) -> list:
    """The sum over the line of each position's total, for each of
    ``lines`` (equal layouts), as one vector (an entry per line), mapped by
    ``then``, on every position."""
    first = lines[0][0].device
    partial = []
    for idx in device_groups(lines[0]):
        block = torch.stack([line[i] for line in lines for i in idx])
        partial.append(_to(block.view(len(lines), -1).sum(dim=1), first))
    total = partial[0] if len(partial) == 1 else torch.stack(partial).sum(dim=0)
    return broadcast(total if then is None else then(total), lines[0])
