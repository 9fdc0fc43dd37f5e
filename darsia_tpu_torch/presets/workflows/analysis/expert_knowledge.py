"""Expert-knowledge ROI constraints on analysis fields.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.expert_knowledge`:
gas saturation may only appear in the configured gas regions, aqueous
concentration only in its regions.  Each support mask is rasterized on the
host once per (field, geometry, device), kept on that device, and applied
with one ``torch.where``.
"""

from __future__ import annotations

import numpy as np
import torch

from ....utils.standard_images import roi_to_mask

__all__ = ["ExpertKnowledgeAdapter"]

#: Output fields that accept expert ROI constraints.
_CONSTRAINED_FIELDS = ("saturation_g", "concentration_aq")


def _geometry_key(image) -> tuple:
    """Hashable fingerprint of an image's raster geometry and device."""
    meta = image.metadata()
    dims = np.asarray(meta.get("dimensions", []), dtype=float)
    origin = np.asarray(meta.get("origin", []), dtype=float)
    return (
        tuple(map(int, image.num_voxels)),
        tuple(dims.tolist()),
        tuple(origin.tolist()),
        str(image.img.device),
    )


def _rasterize(rois: dict, image) -> torch.Tensor:
    """Union of the named ROIs as a boolean voxel mask on ``image``'s device."""
    boxes = [r.roi if hasattr(r, "roi") else r for r in rois.values()]
    return roi_to_mask(boxes, image).img.to(torch.bool)


class ExpertKnowledgeAdapter:
    """Zero scalar fields outside the allowed expert ROIs."""

    def __init__(self, saturation_g_rois=None, concentration_aq_rois=None):
        self._rois = {
            "saturation_g": dict(saturation_g_rois or {}),
            "concentration_aq": dict(concentration_aq_rois or {}),
        }
        self._masks: dict = {}

    @classmethod
    def from_config(cls, config, roi_registry) -> "ExpertKnowledgeAdapter":
        """Resolve the config's ROI name lists against a loaded registry."""
        tables = dict.fromkeys(_CONSTRAINED_FIELDS, None)
        if config is not None and roi_registry is not None:
            for mode in _CONSTRAINED_FIELDS:
                names = getattr(config, mode, None)
                if names:
                    tables[mode] = roi_registry.resolve_rois(names)
        return cls(
            saturation_g_rois=tables["saturation_g"],
            concentration_aq_rois=tables["concentration_aq"],
        )

    def mask_for(self, image, mode: str):
        """Boolean support mask of ``mode`` on ``image``'s device (None: no
        limit)."""
        rois = self._rois.get(mode) or {}
        if not rois:
            return None
        key = (mode, _geometry_key(image))
        mask = self._masks.get(key)
        if mask is None:
            mask = self._masks[key] = _rasterize(rois, image)
        return mask

    def apply(self, image, mode: str):
        """``image`` with its values outside the ``mode`` support set to 0."""
        if image is None:
            return None
        mask = self.mask_for(image, mode)
        if mask is None:
            return image
        return type(image)(img=torch.where(mask, image.img, 0.0), **image.metadata())
