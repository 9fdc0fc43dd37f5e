"""Overlapping tile decomposition of images with blended reassembly.

Counterpart of :mod:`darsia_tpu.image.patches` (2d).  The patches are views
of the base image's tensor; ``assemble`` and ``blend_and_assemble``
accumulate on the base image's device.  The registration does not loop over
patch objects (it cuts all windows in one batch,
:mod:`darsia_tpu_torch.analysis.translationanalysis`); the tiling geometry is
the same.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

from .image import Image, as_tensor

__all__ = ["Patches"]


class Patches:
    """Array of overlapping patches of a 2d image."""

    def __init__(self, img: Image, num_patches, **kwargs) -> None:
        self.base = img
        if self.base.space_dim != 2:
            raise NotImplementedError("Only 2d patches supported.")
        if self.base.time_dim == 1:
            raise NotImplementedError("Space-time patches not supported.")

        if isinstance(num_patches, int):
            num_patches = [num_patches, num_patches]
        self.num_patches = list(num_patches)
        self.num_active_spatial_axes = min(len(self.num_patches), 2)
        self.relative_space_overlap = kwargs.get("rel_overlap", 0.0)

        nv = self.base.num_voxels
        # Patch sizes (voxels) without overlap; the last patch is cut at the
        # image edge.
        pv = [ceil(nv[i] / self.num_patches[i]) for i in range(2)]
        ov = [ceil(self.relative_space_overlap * pv[i]) for i in range(2)]
        self.nv, self.pv, self.ov = nv, pv, ov

        def box(i: int, j: int, o0: int, o1: int) -> tuple:
            return (
                slice(max(i * pv[0] - o0, 0), min((i + 1) * pv[0] + o0, nv[0])),
                slice(max(j * pv[1] - o1, 0), min((j + 1) * pv[1] + o1, nv[1])),
            )

        # ROIs with and without overlap (matrix indexing of patches).
        grid = [range(self.num_patches[0]), range(self.num_patches[1])]
        self.rois = [[box(i, j, ov[0], ov[1]) for j in grid[1]] for i in grid[0]]
        self.rois_without_overlap = [[box(i, j, 0, 0) for j in grid[1]] for i in grid[0]]

        # Patch images, made on first access.
        self._patch_images: dict[tuple[int, int], Image] = {}
        self._weights = None

    # --------------------------------------------------------------- access

    def __call__(self, i: int, j: int) -> Image:
        """Patch (i, j) as a physical sub-image (a view of the base)."""
        if (i, j) not in self._patch_images:
            self._patch_images[(i, j)] = self.base.subregion(self.rois[i][j])
        return self._patch_images[(i, j)]

    def set_image(self, img, i: int, j: int) -> None:
        """Replace the data of patch (i, j) (numpy data goes to the base
        image's device)."""
        self.__call__(i, j).img = as_tensor(img, self.base.img.device)

    @property
    def centers_voxels(self) -> np.ndarray:
        """Voxel centers of all patches (num_i, num_j, 2), matrix indexing."""
        centers = np.zeros((*self.num_patches, 2))
        for i in range(self.num_patches[0]):
            for j in range(self.num_patches[1]):
                roi = self.rois_without_overlap[i][j]
                centers[i, j] = [
                    (roi[0].start + roi[0].stop) / 2,
                    (roi[1].start + roi[1].stop) / 2,
                ]
        return centers

    @property
    def centers_cartesian(self) -> np.ndarray:
        """Cartesian coordinates of patch centers."""
        voxels = self.centers_voxels.reshape(-1, 2)
        coords = np.asarray(self.base.coordinatesystem.coordinate(voxels))
        return coords.reshape((*self.num_patches, 2))

    def position(self, i: int, j: int) -> tuple[str, str]:
        """Position descriptors ("top"/"center"/"bottom", "left"/"center"/"right")."""
        horizontal = "top" if i == 0 else "bottom" if i == self.num_patches[0] - 1 else "center"
        vertical = "left" if j == 0 else "right" if j == self.num_patches[1] - 1 else "center"
        return horizontal, vertical

    # ----------------------------------------------------------- reassembly

    def _prepare_weights(self) -> None:
        """Partition-of-unity ramp weights over the overlap zones (host)."""
        if self._weights is not None:
            return
        self._weights = [[None] * self.num_patches[1] for _ in range(self.num_patches[0])]
        for i in range(self.num_patches[0]):
            for j in range(self.num_patches[1]):
                roi = self.rois[i][j]
                wy = np.ones(roi[0].stop - roi[0].start)
                wx = np.ones(roi[1].stop - roi[1].start)
                # Ramps over doubled overlap regions (2 * ov wide).
                ramp0 = 2 * self.ov[0]
                ramp1 = 2 * self.ov[1]
                if i > 0 and ramp0 > 0:
                    wy[:ramp0] = np.linspace(0, 1, ramp0, endpoint=False)
                if i < self.num_patches[0] - 1 and ramp0 > 0:
                    wy[-ramp0:] = np.linspace(1, 0, ramp0, endpoint=False)
                if j > 0 and ramp1 > 0:
                    wx[:ramp1] = np.linspace(0, 1, ramp1, endpoint=False)
                if j < self.num_patches[1] - 1 and ramp1 > 0:
                    wx[-ramp1:] = np.linspace(1, 0, ramp1, endpoint=False)
                self._weights[i][j] = np.outer(wy, wx)

    def _assembled(self, data: torch.Tensor, update_img: bool) -> Image:
        assembled = type(self.base)(img=data, **self.base.metadata())
        if update_img:
            self.base = assembled
        return assembled

    def assemble(self, update_img: bool = False) -> Image:
        """Reassemble patches (interior parts, no blending)."""
        device = self.base.img.device
        data = torch.zeros(self.base.shape, dtype=torch.float32, device=device)
        for i in range(self.num_patches[0]):
            for j in range(self.num_patches[1]):
                roi_clean = self.rois_without_overlap[i][j]
                roi = self.rois[i][j]
                patch_data = self.__call__(i, j).img.to(device)
                off0 = roi_clean[0].start - roi[0].start
                off1 = roi_clean[1].start - roi[1].start
                h = roi_clean[0].stop - roi_clean[0].start
                w = roi_clean[1].stop - roi_clean[1].start
                data[roi_clean] = patch_data[off0 : off0 + h, off1 : off1 + w].to(torch.float32)
        return self._assembled(data, update_img)

    def blend_and_assemble(self, update_img: bool = False) -> Image:
        """Reassemble with partition-of-unity blending over overlaps."""
        self._prepare_weights()
        device = self.base.img.device
        shape = self.base.shape
        data = torch.zeros(shape, dtype=torch.float32, device=device)
        weight_sum = torch.zeros(shape[:2], dtype=torch.float32, device=device)
        for i in range(self.num_patches[0]):
            for j in range(self.num_patches[1]):
                roi = self.rois[i][j]
                patch_data = self.__call__(i, j).img.to(device, torch.float32)
                weight = torch.from_numpy(self._weights[i][j].astype(np.float32)).to(device)
                data[roi] += patch_data * (weight[..., None] if patch_data.dim() == 3 else weight)
                weight_sum[roi] += weight
        weight_sum = weight_sum.clamp(min=1e-12)
        data /= weight_sum[..., None] if data.dim() == 3 else weight_sum
        return self._assembled(data, update_img)
