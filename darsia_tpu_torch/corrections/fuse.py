"""Fused geometric-correction chains: one warp per chain.

Counterpart of :mod:`darsia_tpu.corrections.fuse` for static members.
Consecutive geometric corrections collapse into a single pull-back
coordinate field (:func:`~darsia_tpu_torch.ops.warp.compose_coordinate_maps`)
and execute as one warp: the two-pass kernel on CUDA, the gather warp on the
CPU.  Fusion protocol (duck-typed): ``pullback_field(input_shape, device) ->
(coords, meta_update)``.  Drift members (``pullback_translation``) are not
ported yet and are refused.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.warp import compose_coordinate_maps, identity_grid, warp_backend
from .base import BaseCorrection

__all__ = [
    "FusedCorrectionChain",
    "apply_transformation_chain",
    "fused_chain",
    "is_static_fusable",
]


def is_static_fusable(correction) -> bool:
    """A correction whose pull-back field depends only on the input shape."""
    return (
        hasattr(correction, "pullback_field")
        and getattr(correction, "fusion_order", 1) == 1
    )


class FusedCorrectionChain(BaseCorrection):
    """A run of static geometric corrections compiled into one field."""

    def __init__(self, corrections: Sequence, input_shape: tuple, device) -> None:
        corrections = list(corrections)
        if not corrections:
            raise ValueError("Empty correction chain.")
        if any(hasattr(c, "pullback_translation") for c in corrections):
            raise NotImplementedError("drift members are not ported yet")
        self.members = corrections
        self.input_shape = tuple(int(s) for s in input_shape)
        self.device = torch.device(device)

        field = None
        meta: dict = {}
        shape = self.input_shape
        for corr in corrections:
            f, meta_update = corr.pullback_field(shape, self.device)
            # F_{k+1}(p) = F_k(f_{k+1}(p)).
            field = f if field is None else compose_coordinate_maps(f, field)
            shape = tuple(int(s) for s in f.shape[1:])
            meta.update(meta_update)
        self.field = field
        self.out_shape = shape
        self._meta = meta
        bound = float((field - identity_grid(shape, self.device)).abs().max())
        self.max_disp = int(np.ceil(bound)) + 1

    def apply_fn(self, dtype: torch.dtype):
        """``apply(img, field, warp_impl="auto") -> corrected`` for ``dtype`` input."""
        max_disp = self.max_disp
        integer = not dtype.is_floating_point

        def apply(img, field, warp_impl="auto"):
            out = warp_backend(
                img.to(torch.float32),
                field,
                order=1,
                max_disp=max_disp,
                warp_impl=warp_impl,
            )
            if integer:
                # torch.round is half-to-even, like jnp.round.
                out = torch.round(out)
            return out.to(dtype)

        return apply

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(img.dtype)(img, self.field)

    def correct_metadata(self, metadata=None) -> dict:
        return dict(self._meta)


#: Fused chains keyed by (member identities + versions, input shape, device):
#: a series of frames corrected with the same objects composes the field once.
#: Entries hold the members, so their ids cannot be recycled while cached.
_CHAIN_CACHE: dict = {}
_CHAIN_CACHE_MAX = 8


def fused_chain(members: Sequence, input_shape: tuple, device) -> FusedCorrectionChain:
    """Cached constructor for :class:`FusedCorrectionChain`."""
    key = (
        tuple((id(c), getattr(c, "_fusion_version", 0)) for c in members),
        tuple(int(s) for s in input_shape),
        torch.device(device),
    )
    chain = _CHAIN_CACHE.get(key)
    if chain is None:
        chain = FusedCorrectionChain(members, input_shape, device)
        if len(_CHAIN_CACHE) >= _CHAIN_CACHE_MAX:
            _CHAIN_CACHE.pop(next(iter(_CHAIN_CACHE)))
        _CHAIN_CACHE[key] = chain
    return chain


def _collect_group(chain: list, i: int) -> int:
    """End index (exclusive) of the maximal fusable run starting at i."""
    j = i
    while j < len(chain) and is_static_fusable(chain[j]):
        j += 1
    return j


def apply_transformation_chain(image, transformations) -> None:
    """Apply a transformation list to an Image, fusing geometric runs.

    Maximal runs of >= 2 fusable corrections execute as one
    :class:`FusedCorrectionChain`; everything else applies one at a time.
    """
    chain = [t for t in transformations if t is not None and callable(t)]
    i = 0
    while i < len(chain):
        j = _collect_group(chain, i)
        if j - i >= 2:
            fused_chain(chain[i:j], image.shape[:2], image.device)(image, overwrite=True)
            i = j
        else:
            chain[i](image, overwrite=True)
            i += 1
