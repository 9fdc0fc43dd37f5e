"""ROI and active-region rendering.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.roi_visualization`.
The mask (the port's ``roi_to_mask``) and the dimmed image are computed on
the image's device; the boundary contours come from OpenCV's
``findContours`` on one host copy of the mask, imported when a partial
mask is rendered (where OpenCV does not import, that raises ``ImportError``
naming it).  :func:`draw_active_region` draws on a matplotlib axis the
caller gives.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ....image.image import as_numpy, as_tensor
from ....utils.optional import optional_module
from ....utils.standard_images import roi_to_mask

__all__ = [
    "ActiveRegionRenderData",
    "build_active_mask_from_rois",
    "render_active_region",
    "draw_active_region",
]


@dataclass(frozen=True)
class ActiveRegionRenderData:
    """The rendered active-region image and its mask (tensors on the image's
    device) and the mask's boundary contours ((N, 2) host arrays of (row,
    col))."""

    image: torch.Tensor
    mask: torch.Tensor
    contours: list = field(default_factory=list)


def _find_contours(mask: np.ndarray) -> list:
    cv2 = optional_module("cv2", "the active region's contours (cv2.findContours)")
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    return list(contours)


def build_active_mask_from_rois(rois, reference_image) -> torch.Tensor:
    """Union mask of ROI configs or arrays on the reference image's grid, a
    boolean tensor on its device."""
    entries = list(rois.values()) if isinstance(rois, dict) else list(rois)
    mask = roi_to_mask([roi.roi if hasattr(roi, "roi") else roi for roi in entries], reference_image)
    return mask.img.to(torch.bool)


def render_active_region(image, active_mask=None, dim_factor: float = 0.35) -> ActiveRegionRenderData:
    """Dim the inactive region (float64, clipped to [0, 1]) and extract the
    mask's boundary contours."""
    data = as_tensor(image.img if hasattr(image, "img") else image).to(torch.float64)
    if data.dim() == 2:
        data = torch.stack([data] * 3, dim=-1)
    if active_mask is None:
        active = torch.ones(data.shape[:2], dtype=torch.bool, device=data.device)
    else:
        active = as_tensor(getattr(active_mask, "img", active_mask), data.device).to(torch.bool)
        assert tuple(active.shape[:2]) == tuple(data.shape[:2]), "Mask shape mismatch."
    out = torch.where(active[..., None], data, data * dim_factor)
    contours: list = []
    if bool(active.any()) and not bool(active.all()):
        # cv2 contours are (N, 1, 2) in (col, row); (N, 2) in (row, col) here.
        contours = [
            np.asarray(c, dtype=float).reshape(-1, 2)[:, ::-1] for c in _find_contours(as_numpy(active))
        ]
    return ActiveRegionRenderData(image=out.clamp(0, 1), mask=active, contours=contours)


def draw_active_region(ax, image, active_mask=None, title: str = "", stroke_color: str = "y"):
    """Draw the dimmed active region and its boundary on a matplotlib axis."""
    render_data = render_active_region(image, active_mask)
    ax.imshow(as_numpy(render_data.image))
    ax.contour(
        as_numpy(render_data.mask).astype(float),
        levels=[0.5],
        colors=[stroke_color],
        linewidths=1.5,
    )
    if title:
        ax.set_title(title)
    ax.set_axis_off()
    return render_data
