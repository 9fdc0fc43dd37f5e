"""Fused geometric-correction chains: one warp per chain.

Counterpart of :mod:`darsia_tpu.corrections.fuse`.  Consecutive geometric
corrections collapse into a single pull-back coordinate field
(:func:`~darsia_tpu_torch.ops.warp.compose_coordinate_maps`) and execute as
one warp: the two-pass kernel on CUDA, the gather warp on the CPU.

Fusion protocol (duck-typed):

* ``pullback_field(input_shape, device) -> (coords, meta_update)``: a static
  field that depends only on the input shape.
* ``pullback_translation(img) -> (2,)``: a per-image rigid translation
  (drift), as a tensor on the image's device.  It composes exactly with the
  static field when it leads the chain (the innermost map): it is clipped to
  the member's ``max_displacement`` and added to the field on the device,
  so drift and the static corrections still cost one warp, whose bound
  covers both.

A series is one warp too when the chain is static (its frames folded into
the channels); a chain with a drift member warps each frame alone, since
each has its own translation.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..ops.warp import compose_coordinate_maps, identity_grid, warp_backend
from .base import BaseCorrection

__all__ = [
    "DEFAULT_DYNAMIC_DISP",
    "FusedCorrectionChain",
    "apply_transformation_chain",
    "fused_chain",
    "is_dynamic_fusable",
    "is_static_fusable",
]

#: Default bound (voxels) of a drift member's translation in a fused chain.
DEFAULT_DYNAMIC_DISP = 64.0


def is_static_fusable(correction) -> bool:
    """A correction whose pull-back field depends only on the input shape."""
    return (
        hasattr(correction, "pullback_field")
        and getattr(correction, "fusion_order", 1) == 1
    )


def is_dynamic_fusable(correction) -> bool:
    """A correction contributing a per-image rigid translation (drift)."""
    return hasattr(correction, "pullback_translation")


class FusedCorrectionChain(BaseCorrection):
    """A run of geometric corrections compiled into one field, optionally led
    by one drift member."""

    def __init__(self, corrections: Sequence, input_shape: tuple, device) -> None:
        corrections = list(corrections)
        if not corrections:
            raise ValueError("Empty correction chain.")
        self.members = corrections
        self.input_shape = tuple(int(s) for s in input_shape)
        self.device = torch.device(device)

        self._dynamic = None
        start = 0
        if is_dynamic_fusable(corrections[0]):
            self._dynamic = corrections[0]
            start = 1
        if any(is_dynamic_fusable(c) for c in corrections[start:]):
            raise ValueError("Dynamic (drift-like) corrections fuse only at chain start.")

        field = None
        meta: dict = {}
        shape = self.input_shape
        for corr in corrections[start:]:
            f, meta_update = corr.pullback_field(shape, self.device)
            # F_{k+1}(p) = F_k(f_{k+1}(p)).
            field = f if field is None else compose_coordinate_maps(f, field)
            shape = tuple(int(s) for s in f.shape[1:])
            meta.update(meta_update)
        if field is None:
            field = identity_grid(shape, self.device)
        self.field = field
        self.out_shape = shape
        self._meta = meta
        self.static_disp = float((field - identity_grid(shape, self.device)).abs().max())
        max_disp = int(np.ceil(self.static_disp)) + 1
        if self._dynamic is not None:
            max_disp += int(np.ceil(self._dynamic_bound()))
        self.max_disp = max_disp

    def _dynamic_bound(self) -> float:
        return float(getattr(self._dynamic, "max_displacement", DEFAULT_DYNAMIC_DISP))

    def apply_fn(self, dtype: torch.dtype):
        """``apply(img, field, warp_impl="auto") -> corrected`` for ``dtype``
        input: the drift estimate (if any) shifts the field on the device,
        then one warp."""
        dynamic = self._dynamic
        bound = None if dynamic is None else self._dynamic_bound()
        max_disp = self.max_disp
        integer = not dtype.is_floating_point

        def apply(img, field, warp_impl="auto"):
            coords = field
            if dynamic is not None:
                t = dynamic.pullback_translation(img).clamp(-bound, bound)
                coords = coords + t.reshape(2, 1, 1)
            out = warp_backend(
                img.to(torch.float32),
                coords,
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

    def correct_series_array(self, img: torch.Tensor, time_axis: int) -> torch.Tensor:
        """Correct a whole (H, W, T[, C]) series.

        A static chain shares its field with every frame, so the time and
        range axes fold into the warp's channel axis: on CUDA one pair of K1
        launches corrects the series.  With a drift member each frame is
        warped alone (one K1 pair per frame).  Either way each frame gets
        the same bits as when corrected alone.
        """
        if time_axis != 2:
            raise ValueError("a 2-D series carries its time axis at 2")
        apply = self.apply_fn(img.dtype)
        if self._dynamic is not None:
            frames = [
                apply(img.select(2, k).contiguous(), self.field)
                for k in range(img.shape[2])
            ]
            return torch.stack(frames, dim=2)
        H, W = img.shape[:2]
        out = apply(img.reshape(H, W, -1), self.field)
        return out.reshape(tuple(out.shape[:2]) + tuple(img.shape[2:]))

    def correct_metadata(self, metadata=None) -> dict:
        return dict(self._meta)


#: Fused chains keyed by (member identities + versions, input shape, device):
#: a series of frames corrected with the same objects composes the field once.
#: Entries hold the members, so their ids cannot be recycled while cached.
#: Threads reading together (``utils/prefetch.py``) build a chain once, under
#: ``_CHAIN_LOCK``.
_CHAIN_CACHE: dict = {}
_CHAIN_CACHE_MAX = 8
_CHAIN_LOCK = threading.Lock()


def fused_chain(members: Sequence, input_shape: tuple, device) -> FusedCorrectionChain:
    """Cached constructor for :class:`FusedCorrectionChain`."""
    key = (
        tuple((id(c), getattr(c, "_fusion_version", 0)) for c in members),
        tuple(int(s) for s in input_shape),
        torch.device(device),
    )
    chain = _CHAIN_CACHE.get(key)
    if chain is None:
        with _CHAIN_LOCK:
            chain = _CHAIN_CACHE.get(key)
            if chain is None:
                chain = FusedCorrectionChain(members, input_shape, device)
                if len(_CHAIN_CACHE) >= _CHAIN_CACHE_MAX:
                    _CHAIN_CACHE.pop(next(iter(_CHAIN_CACHE)))
                _CHAIN_CACHE[key] = chain
    return chain


def _collect_group(chain: list, i: int) -> int:
    """End index (exclusive) of the maximal fusable run starting at i: an
    optional leading drift member, then static members."""
    j = i
    if j < len(chain) and is_dynamic_fusable(chain[j]):
        j += 1
    while j < len(chain) and is_static_fusable(chain[j]):
        j += 1
    return j


def apply_transformation_chain(image, transformations) -> None:
    """Apply a transformation list to an Image, fusing geometric runs.

    Maximal runs of >= 2 fusable corrections execute as one
    :class:`FusedCorrectionChain`; everything else applies one at a time.
    A failure to fuse raises: nothing falls back to the sequential path.
    """
    chain = [t for t in transformations if t is not None and callable(t)]
    fuse = image.space_dim == 2
    i = 0
    while i < len(chain):
        j = _collect_group(chain, i) if fuse else i
        if j - i >= 2:
            fused_chain(chain[i:j], image.shape[:2], image.device)(image, overwrite=True)
            i = j
        else:
            chain[i](image, overwrite=True)
            i += 1
