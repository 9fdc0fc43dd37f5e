"""Map one image onto another image's coordinate system.

Counterpart of :mod:`darsia_tpu.image.coordinatetransformation`: affine
alignment between two physical coordinate systems
(:class:`~darsia_tpu_torch.corrections.shape.affine.AffineCorrection`, a
gather warp on the image's device) and restriction to the intersection of the
two domains.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..corrections.shape.affine import AffineCorrection
from ..utils.point import Coordinate, CoordinateArray, make_coordinate, make_voxel
from .image import Image

__all__ = ["CoordinateTransformation"]


class CoordinateTransformation:
    """Affine coordinate alignment between two images' systems."""

    def __init__(
        self,
        coordinatesystem_src,
        coordinatesystem_dst,
        pts_src,
        pts_dst,
        fit_options: Optional[dict] = None,
    ) -> None:
        self.coordinatesystem_src = coordinatesystem_src
        self.coordinatesystem_dst = coordinatesystem_dst
        self.correction = AffineCorrection(
            coordinatesystem_src,
            coordinatesystem_dst,
            pts_src,
            pts_dst,
            fit_options,
        )

    def find_intersection(self) -> tuple:
        """Voxel ROI (in the dst system) of the domain intersection.

        The corner points are mapped in the point flavour the transformation
        was fitted with (voxels or coordinates).
        """
        src = self.coordinatesystem_src
        dst = self.coordinatesystem_dst
        corners_voxels = np.array(
            [
                [0, 0],
                [src.shape[0], 0],
                [src.shape[0], src.shape[1]],
                [0, src.shape[1]],
            ]
        )
        transformation = self.correction.transformation
        coordinate_fit = transformation.input_dtype in (
            Coordinate,
            CoordinateArray,
        ) or transformation.input_array_dtype is CoordinateArray

        if coordinate_fit:
            coords = np.asarray(src.coordinate(corners_voxels))
            mapped = np.atleast_2d(
                np.asarray(self.correction.transformation(make_coordinate(coords)))
            )
            xmin = max(dst.domain["xmin"], float(mapped[:, 0].min()))
            xmax = min(dst.domain["xmax"], float(mapped[:, 0].max()))
            ymin = max(dst.domain["ymin"], float(mapped[:, 1].min()))
            ymax = min(dst.domain["ymax"], float(mapped[:, 1].max()))
            if xmin >= xmax or ymin >= ymax:
                raise ValueError("Empty intersection of domains.")
            voxels = np.asarray(
                dst.voxel(np.array([[xmin, ymax], [xmax, ymin]]))
            )
            rows = sorted((int(voxels[0, 0]), int(voxels[1, 0])))
            cols = sorted((int(voxels[0, 1]), int(voxels[1, 1])))
        else:
            mapped = np.atleast_2d(
                np.asarray(
                    transformation(make_voxel(corners_voxels.astype(float)))
                )
            )
            rows = [int(np.ceil(mapped[:, 0].min())), int(np.floor(mapped[:, 0].max()))]
            cols = [int(np.ceil(mapped[:, 1].min())), int(np.floor(mapped[:, 1].max()))]

        roi = (
            slice(max(rows[0], 0), min(rows[1], dst.shape[0])),
            slice(max(cols[0], 0), min(cols[1], dst.shape[1])),
        )
        if roi[0].start >= roi[0].stop or roi[1].start >= roi[1].stop:
            raise ValueError("Empty intersection of domains.")
        return roi

    def correct_metadata(self, image: Image) -> dict:
        """Metadata of the destination system for a given source image."""
        meta = dict(image.metadata())
        meta["dimensions"] = list(self.coordinatesystem_dst.dimensions)
        meta["origin"] = self.coordinatesystem_dst._coordinate_of_origin_voxel.copy()
        return meta

    def __call__(self, img: Image) -> Image:
        """Warp an image into the destination system, cropped to overlap."""
        warped = self.correction(img)
        roi = self.find_intersection()
        return warped.subregion(roi)
