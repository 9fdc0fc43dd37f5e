"""Crop assistant: four corner points -> a CurvatureCorrection crop config.

Counterpart of :mod:`darsia_tpu.assistants.crop_assistant`.  The corners
are clicked, given as ``points=``, or found by :meth:`CropAssistant.from_image`
from marks of one colour near the image's corners: the colour comparison
runs on the image's device (:func:`darsia_tpu_torch.utils.detection.detect_color`),
and only the voxels it finds are copied to the host.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..utils.detection import detect_closest_point, detect_color
from ..utils.point import VoxelArray, make_voxel
from .selection_assistants import PointSelectionAssistant, _space_shape

__all__ = ["CropAssistant"]


class CropAssistant(PointSelectionAssistant):
    """Build the 'crop' config of a CurvatureCorrection."""

    def __init__(
        self,
        img,
        width: Optional[float] = None,
        height: Optional[float] = None,
        **kwargs,
    ) -> None:
        super().__init__(img, **kwargs)
        self.width = width
        self.height = height

    def __call__(self) -> dict:
        pts = super().__call__()
        assert len(pts) == 4, "Wrong number of points selected."
        self.pts = pts
        assert self.width is not None and self.height is not None, (
            "Provide width and height (interactive prompt not available headless)."
        )
        return self._define_config()

    def _define_config(self) -> dict:
        return {
            "crop": {
                "width": self.width,
                "height": self.height,
                "pts_src": np.asarray(self.pts),
            }
        }

    def from_image(
        self,
        color: Union[list, np.ndarray],
        width: Optional[float] = None,
        height: Optional[float] = None,
    ) -> dict:
        """Automatic mode: the marks of ``color`` closest to the image's
        corners."""
        color = np.asarray(color, dtype=float)
        self.pts = self._find_marks(color)
        if self.width is None:
            assert width is not None, "Width not provided."
            self.width = width
        if self.height is None:
            assert height is not None, "Height not provided."
            self.height = height
        return self._define_config()

    def _find_marks(self, color) -> VoxelArray:
        marked = detect_color(self.img, color, tolerance=5e-2)
        rows, cols = _space_shape(self.img)
        top_left = detect_closest_point(marked, make_voxel([0, 0]))
        top_right = detect_closest_point(marked, make_voxel([0, cols]))
        bottom_left = detect_closest_point(marked, make_voxel([rows, 0]))
        bottom_right = detect_closest_point(marked, make_voxel([rows, cols]))
        return make_voxel(np.asarray([top_left, bottom_left, bottom_right, top_right]))
