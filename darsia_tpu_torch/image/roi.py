"""Polygonal regions of interest in physical coordinates.

Counterpart of :mod:`darsia_tpu.image.roi` (host-side numpy, as there):
point-in-polygon by the even-odd ray-casting rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.point import make_coordinate

__all__ = ["ROI"]


class ROI:
    """2d polygonal region of interest in global (physical) coordinates."""

    def __init__(self, coordinates) -> None:
        pts = [np.asarray(c, dtype=float) for c in coordinates]
        if not all(p.shape[-1] == 2 for p in pts):
            raise ValueError("Only 2d polygons supported.")
        if not np.allclose(pts[0], pts[-1]):
            pts.append(pts[0])
        self.vertices = np.asarray(pts)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(min_x, min_y, max_x, max_y)."""
        return (
            float(self.vertices[:, 0].min()),
            float(self.vertices[:, 1].min()),
            float(self.vertices[:, 0].max()),
            float(self.vertices[:, 1].max()),
        )

    def contains(self, point) -> bool:
        """Even-odd rule point-in-polygon test."""
        x, y = float(np.asarray(point)[0]), float(np.asarray(point)[1])
        inside = False
        v = self.vertices
        for i in range(len(v) - 1):
            x1, y1 = v[i]
            x2, y2 = v[i + 1]
            if (y1 > y) != (y2 > y):
                x_cross = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
                if x < x_cross:
                    inside = not inside
        return inside

    def mask(self, image) -> np.ndarray:
        """Boolean voxel mask of the polygon on an image's grid."""
        cs = image.coordinatesystem
        coords = np.asarray(cs.coordinates, dtype=float)
        v = self.vertices
        x = coords[:, 0]
        y = coords[:, 1]
        inside = np.zeros(len(coords), dtype=bool)
        for i in range(len(v) - 1):
            x1, y1 = v[i]
            x2, y2 = v[i + 1]
            crosses = (y1 > y) != (y2 > y)
            with np.errstate(divide="ignore", invalid="ignore"):
                x_cross = x1 + (y - y1) / (y2 - y1 + 1e-30) * (x2 - x1)
            inside ^= crosses & (x < x_cross)
        return inside.reshape(cs.shape, order="F")

    def __repr__(self) -> str:
        return f"ROI({self.vertices.tolist()})"

    def extract_subregion(self, image):
        """Bounding-box subregion of the polygon applied to an image."""
        min_x, min_y, max_x, max_y = self.bounds
        return image.subregion(
            make_coordinate([[min_x, min_y], [max_x, max_y]])
        )

    # ROIs are callable on images: ``image.roi(roi)`` is ``roi(image)``.
    __call__ = extract_subregion
