"""Restoration construction with rig-derived ignore masks.

Counterpart of :mod:`darsia_tpu.presets.workflows.restoration`.  The masks
and weight fields are tensors on the rig's device, and so is the
restoration built from them.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ...image.image import as_tensor
from ...restoration.averaging import REV, VolumeAveraging
from ...restoration.tvd import TVD

logger = logging.getLogger(__name__)

__all__ = ["RestorationMaskFactory", "build_restoration"]


class RestorationMaskFactory:
    """Boolean ignore masks from the rig's fields, by name, on the rig's
    device."""

    def __init__(self, fluidflower) -> None:
        self.fluidflower = fluidflower
        self._builders = {
            "image_porosity": self._image_porosity_ignore_mask,
            "boolean_porosity": self._boolean_porosity_ignore_mask,
            "inner_labels": self._inner_labels_ignore_mask,
        }

    def _field(self, name: str) -> torch.Tensor:
        return as_tensor(getattr(self.fluidflower, name).img, self.fluidflower.device)

    def _image_porosity_ignore_mask(self) -> torch.Tensor:
        return self._field("image_porosity") <= 0

    def _boolean_porosity_ignore_mask(self) -> torch.Tensor:
        return ~self._field("boolean_porosity").to(torch.bool)

    def _inner_labels_ignore_mask(self) -> torch.Tensor:
        return ~self._field("inner_labels").to(torch.bool)

    def build_ignore_mask(self, mask_names: list) -> Optional[torch.Tensor]:
        if not mask_names:
            return None
        ignore = None
        for name in mask_names:
            if name not in self._builders:
                raise ValueError(
                    f"Unknown restoration ignore mask {name!r}. Valid: {list(self._builders)}."
                )
            current = self._builders[name]()
            ignore = current if ignore is None else ignore | current
        return ignore


def build_restoration(restoration_config, fluidflower):
    """The configured restoration with rig-derived masks, on the rig's
    device."""
    if restoration_config is None or restoration_config.method is None:
        logger.info("No restoration configured; proceeding without.")
        return None
    device = fluidflower.device
    ignore = RestorationMaskFactory(fluidflower).build_ignore_mask(
        list(getattr(restoration_config, "ignore", []) or [])
    )
    method = restoration_config.method
    if method in ("volume_average", "volume_averaging"):
        shape = tuple(fluidflower.baseline.img.shape[:2])
        mask = torch.ones(shape, dtype=torch.bool, device=device) if ignore is None else ~ignore
        rev = REV(float(restoration_config.options.rev_size), fluidflower.baseline)
        return VolumeAveraging(rev, mask=mask, device=device)
    if method == "tvd":
        options = restoration_config.options
        weight = options.weight
        if isinstance(weight, str):
            # "image_porosity" / "boolean_porosity" weight fields (float32, as
            # JAX holds the float64 field without x64).
            weight = as_tensor(getattr(fluidflower, weight).img, device).to(torch.float32)
        return TVD(
            weight=weight,
            method=options.method,
            max_num_iter=options.max_num_iter,
            eps=options.eps,
            omega=options.omega,
            regularization=options.regularization,
            device=device,
            **options.kwargs,
        )
    raise ValueError(f"Unknown restoration method {method!r}.")
