"""Dimension reduction / extrusion of physical images.

Counterpart of :mod:`darsia_tpu.signals.reduction.dimensionreduction`.  The
data is reduced on the image's device; the metadata (dropping a Cartesian
axis, recomputing the origin) is host-side.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ...image.indexing import interpret_indexing

__all__ = ["AxisReduction", "extrude_along_axis", "reduce_axis"]


class AxisReduction:
    """Reduce a spatial axis of an image: "average", "sum", or "slice" (at
    the voxel index ``slice_idx``; a view of the tensor)."""

    def __init__(
        self, axis: Union[str, int], dim: int = 3, mode: str = "average", **kwargs
    ) -> None:
        if isinstance(axis, str):
            if axis not in "xyz"[:dim]:
                raise ValueError(f"axis {axis!r} not in {'xyz'[:dim]!r}")
            index, _ = interpret_indexing(axis, "ijk"[:dim])
        else:
            if axis not in range(dim):
                raise ValueError(f"axis {axis} not in range({dim})")
            index = axis
            cartesian_index, _ = interpret_indexing("ijk"[:dim][index], "xyz"[:dim])
            axis = "xyz"[cartesian_index]
        self.index: int = index
        self.axis: int = "xyz".find(axis)
        self.mode: str = mode
        self.kwargs = kwargs

    def __call__(self, img):
        original_dim = img.space_dim
        original_axes = "xyz"[:original_dim]
        original_indexing = img.indexing
        if original_indexing != "ijk"[:original_dim]:
            raise NotImplementedError("Standard matrix indexing required.")
        new_dim = original_dim - 1
        new_axes = "xyz"[:new_dim]
        new_indexing = "ijk"[:new_dim]

        if self.mode in ("average", "sum"):
            data = torch.sum(img.img.to(torch.float32), dim=self.index)
            if self.mode == "average":
                data = data / img.img.shape[self.index]
        elif self.mode == "slice":
            data = img.img.select(self.index, self.kwargs["slice_idx"])
        else:
            raise ValueError(f"Mode {self.mode} not supported.")

        new_dimensions = list(img.dimensions)
        new_dimensions.pop(self.index)

        # Cartesian min corner of the original domain, without the reduced axis.
        min_corner = np.asarray(img.origin, dtype=float).copy()
        for index, matrix_index in enumerate(original_indexing):
            axis_pos, reverse_axis = interpret_indexing(matrix_index, original_axes)
            if reverse_axis:
                min_corner[axis_pos] -= img.dimensions[index]
        new_origin = np.delete(min_corner, self.axis)
        for new_index, new_matrix_index in enumerate(new_indexing):
            new_cartesian_index, revert_axis = interpret_indexing(new_matrix_index, new_axes)
            if revert_axis:
                new_origin[new_cartesian_index] += new_dimensions[new_index]

        metadata = img.metadata()
        metadata["space_dim"] = new_dim
        metadata["indexing"] = new_indexing
        metadata["origin"] = new_origin
        metadata["dimensions"] = new_dimensions
        return type(img)(img=data, **metadata)


def reduce_axis(image, axis: Union[str, int], mode: str = "average", **kwargs):
    """Reduce one spatial axis of ``image`` (see :class:`AxisReduction`)."""
    return AxisReduction(axis, image.space_dim, mode, **kwargs)(image)


def extrude_along_axis(img, height: float, num: int):
    """Extrude a 2-D image into 3-D along the z axis (``num`` copies)."""
    meta = img.metadata()
    if meta["space_dim"] != 2:
        raise ValueError("only 2-D images can be extruded")
    meta["space_dim"] = 3
    meta["dimensions"] = [height, *meta["dimensions"]]
    meta["indexing"] = "ijk"
    meta["origin"] = np.array([height, *np.asarray(meta["origin"])])
    data = img.img[None].expand(num, *img.img.shape).contiguous()
    return type(img)(img=data, **meta)
