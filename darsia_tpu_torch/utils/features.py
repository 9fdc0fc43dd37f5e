"""Feature-based image matching (ORB-free).

Counterpart of :mod:`darsia_tpu.utils.features`: Harris corners as keypoint
locations, normalised 8x8 patches as descriptors, and matching through the
dominant translation that FFT phase correlation estimates.

The Harris response, and the masking before it, are computed on the
image's device (a numpy input goes to ``device``, the CUDA card when None);
only the response and the gray image (for the 8x8 descriptor patches) are
copied to the host.  ``jax.scipy.signal.convolve2d``
is a true convolution with zero fill, so ``conv2d`` (a correlation) takes
the flipped derivative kernel; the 5x5 box is symmetric.  The
non-maximum suppression (``ndimage.maximum_filter``, mode "reflect") and
the ordering (``np.argsort(...)[::-1]``) stay on the host, as in the JAX
package, so ties order the same way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..image.image import as_tensor
from ..ops.fft import phase_correlation

__all__ = ["FeatureDetection", "harris_corners"]


def _convolve_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``convolve2d(x, kernel, mode="same")`` with zero fill (odd kernels)."""
    flipped = torch.flip(kernel, dims=(0, 1))[None, None]
    padding = (kernel.shape[0] // 2, kernel.shape[1] // 2)
    return F.conv2d(x[None, None], flipped, padding=padding)[0, 0]


def _harris_response(gray, k: float = 0.05, device=None) -> torch.Tensor:
    """The Harris response ``det - k trace**2`` of a 2-D image, on its device."""
    g = as_tensor(gray, device).to(torch.float32)
    kx = torch.tensor([[-1.0, 0.0, 1.0]], device=g.device)
    gx = _convolve_same(g, kx)
    gy = _convolve_same(g, kx.T)
    win = torch.full((5, 5), 1.0 / 25.0, device=g.device)
    sxx = _convolve_same(gx * gx, win)
    syy = _convolve_same(gy * gy, win)
    sxy = _convolve_same(gx * gy, win)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace**2


def harris_corners(gray, max_features: int = 200, k: float = 0.05, device=None) -> np.ndarray:
    """Harris corner keypoints (row, col), strongest first."""
    from scipy import ndimage

    response = _harris_response(gray, k, device).cpu().numpy()
    # Non-maximum suppression on a coarse grid.
    maxima = response == ndimage.maximum_filter(response, size=9)
    response = np.where(maxima, response, -np.inf)
    flat = np.argsort(response.ravel())[::-1][:max_features]
    rows, cols = np.unravel_index(flat, response.shape)
    keep = response[rows, cols] > 0
    return np.stack([rows[keep], cols[keep]], axis=1)


class FeatureDetection:
    """Feature detection + matching facade.

    ``find_matches`` returns matched point pairs consistent with the
    dominant rigid translation between the images (estimated by phase
    correlation): keypoints of the source plus their translated partners.
    Images go to ``device`` (the CUDA card when None) unless they are
    tensors or port images already.
    """

    def __init__(self, max_features: int = 200, tol: float = 0.05, device=None) -> None:
        self.max_features = max_features
        self.tol = tol
        self.device = device

    def detect(self, img) -> np.ndarray:
        gray = self._gray(img, self.device)
        return harris_corners(gray, self.max_features)

    @staticmethod
    def _gray(img, device=None) -> torch.Tensor:
        """The float32 gray image on the image's device."""
        arr = as_tensor(img.img if hasattr(img, "img") else img, device)
        if arr.dim() == 3:
            from ..ops.color import rgb_to_gray

            return rgb_to_gray(arr.to(torch.float32))
        return arr.to(torch.float32)

    @classmethod
    def extract_features(
        cls,
        img,
        roi: Optional[tuple] = None,
        mask: Optional[np.ndarray] = None,
        max_features: int = 200,
        device=None,
    ) -> tuple:
        """Extract (keypoints, patch descriptors) from an image region.

        Returns a tuple ``(keypoints (N, 2) row/col, descriptors (N, D))``.
        """
        gray = cls._gray(img, device)
        if roi is not None:
            gray = gray[roi]
        if mask is not None:
            keep = as_tensor(np.asarray(mask, dtype=bool)[: gray.shape[0], : gray.shape[1]], gray.device)
            gray = torch.where(keep, gray, torch.zeros((), device=gray.device))
        keypoints = harris_corners(gray.contiguous(), max_features)
        # Descriptor: normalized 8x8 intensity patch around each corner, cut
        # from the host copy.
        half = 4
        padded = np.pad(gray.cpu().numpy(), half, mode="edge")
        descriptors = (
            np.stack([padded[r : r + 2 * half, c : c + 2 * half].ravel() for r, c in keypoints])
            if len(keypoints)
            else np.zeros((0, 64), dtype=np.float32)
        )
        if len(descriptors):
            descriptors = descriptors - descriptors.mean(axis=1, keepdims=True)
            norms = np.linalg.norm(descriptors, axis=1, keepdims=True)
            descriptors = descriptors / np.maximum(norms, 1e-12)
        return keypoints.astype(float), descriptors.astype(np.float32)

    @classmethod
    def match_features(
        cls,
        features_src: tuple,
        features_dst: tuple,
        keep_percent: float = 0.1,
        return_matches: bool = False,
    ) -> tuple:
        """Match feature sets by descriptor correlation (mutual best, the
        strongest ``keep_percent`` kept).

        Returns ``(pts_src, pts_dst)`` of the kept matches, plus the match
        index pairs when ``return_matches``.
        """
        kp_src, desc_src = features_src
        kp_dst, desc_dst = features_dst
        if len(kp_src) == 0 or len(kp_dst) == 0:
            empty = np.zeros((0, 2))
            return (empty, empty, np.zeros((0, 2), int)) if return_matches else (empty, empty)
        score = desc_src @ desc_dst.T  # cosine similarity
        best = np.argmax(score, axis=1)
        quality = score[np.arange(len(kp_src)), best]
        mutual = np.argmax(score, axis=0)[best] == np.arange(len(kp_src))
        order = np.argsort(quality)[::-1]
        keep = max(int(np.ceil(keep_percent * len(order))), 1)
        selected = np.array([i for i in order[: 10 * keep] if mutual[i]][:keep], dtype=int)
        pts_src = np.asarray(kp_src, dtype=float)[selected]
        pts_dst = np.asarray(kp_dst, dtype=float)[best[selected]]
        if return_matches:
            matches = np.stack([selected, best[selected]], axis=1)
            return pts_src, pts_dst, matches
        return pts_src, pts_dst

    def find_matches(
        self,
        img_src,
        img_dst,
        mask_src: Optional[np.ndarray] = None,
        mask_dst: Optional[np.ndarray] = None,
    ):
        """Matched keypoint pairs ((N, 2) source voxels, (N, 2) dest voxels).

        Returns (pts_src, pts_dst, success).
        """
        a = self._gray(img_src, self.device)
        b = self._gray(img_dst, self.device).to(a.device)
        h = min(a.shape[0], b.shape[0])
        w = min(a.shape[1], b.shape[1])
        if mask_src is not None:
            keep = as_tensor(np.asarray(mask_src)[: a.shape[0], : a.shape[1]], a.device)
            a = torch.where(keep, a, torch.zeros((), device=a.device))
        if mask_dst is not None:
            keep = as_tensor(np.asarray(mask_dst)[: b.shape[0], : b.shape[1]], b.device)
            b = torch.where(keep, b, torch.zeros((), device=b.device))
        shift, _ = phase_correlation(a[:h, :w].contiguous(), b[:h, :w].contiguous())
        shift = shift.cpu().numpy()
        if not np.isfinite(shift).all():
            return np.zeros((0, 2)), np.zeros((0, 2)), False
        pts_src = self.detect(a).astype(float)
        if len(pts_src) == 0:
            return np.zeros((0, 2)), np.zeros((0, 2)), False
        pts_dst = pts_src + shift[None, :]
        inside = (
            (pts_dst[:, 0] >= 0)
            & (pts_dst[:, 0] < b.shape[0])
            & (pts_dst[:, 1] >= 0)
            & (pts_dst[:, 1] < b.shape[1])
        )
        return pts_src[inside], pts_dst[inside], bool(inside.any())
