"""Earth mover's distance through OpenCV's ``cv2.EMD``.

Counterpart of :mod:`darsia_tpu.measure.emd`.  ``cv2.EMD`` solves the exact
transport problem between the signatures of the nonzero pixels on the host
(OpenCV is imported when called), on host copies of the images.
It suits validation and small images; the solvers on the card are the
Beckmann family of :mod:`darsia_tpu_torch.measure.beckmann`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..image.image import as_numpy
from ..utils.optional import optional_module

__all__ = ["EMD"]


class EMD:
    """EMD between two images with identical total mass."""

    def __init__(self, preprocess: Optional[Callable] = None, **kwargs) -> None:
        self.preprocess = preprocess

    def __call__(self, img_1, img_2) -> float:
        cv2 = optional_module("cv2", "the earth mover's distance (cv2.EMD)")
        if self.preprocess is not None:
            img_1 = self.preprocess(img_1)
            img_2 = self.preprocess(img_2)
        self._compatibility_check(img_1, img_2)

        # cv2.EMD returns the work over the total weight: the signatures are
        # normalised to unit mass, and the distance is rescaled by the
        # integral and the cell volume, as the Beckmann solvers measure it.
        cell_volume = float(np.prod(np.asarray(img_1.voxel_size)))
        integral = float(np.sum(as_numpy(img_1.img)))
        sig_1 = self._img_to_signature(img_1, normalization=integral)
        sig_2 = self._img_to_signature(img_2, normalization=integral)
        distance, _, _ = cv2.EMD(sig_1, sig_2, cv2.DIST_L2)
        return float(distance) * integral * cell_volume

    def distance_matrix(self, images: list) -> np.ndarray:
        """Symmetric N x N matrix of pairwise EMDs."""
        n = len(images)
        matrix = np.zeros((n, n), dtype=float)
        for i in range(n):
            for j in range(i + 1, n):
                matrix[i, j] = self(images[i], images[j])
                matrix[j, i] = matrix[i, j]
        return matrix

    def _compatibility_check(self, img_1, img_2) -> None:
        assert img_1.space_dim == 2 and img_2.space_dim == 2
        assert img_1.scalar and img_2.scalar
        assert tuple(img_1.num_voxels) == tuple(img_2.num_voxels)
        # Equal mass, to a relative 1e-3.
        sum_1 = float(np.sum(as_numpy(img_1.img)))
        sum_2 = float(np.sum(as_numpy(img_2.img)))
        if not np.isclose(sum_1, sum_2, rtol=1e-3):
            raise ValueError("Images must have the same total mass.")

    @staticmethod
    def _img_to_signature(img, normalization: float = 1.0) -> np.ndarray:
        """(N, 3) float32 rows ``(mass, x, y)`` of the nonzero pixels."""
        data = np.asarray(as_numpy(img.img), dtype=np.float32)
        if normalization not in (0.0, 1.0):
            data = data / np.float32(normalization)
        rows, cols = np.nonzero(data)
        values = data[rows, cols]
        coords = np.asarray(img.coordinatesystem.coordinate(np.stack([rows, cols], axis=1)))
        return np.concatenate([values[:, None], coords.astype(np.float32)], axis=1)
