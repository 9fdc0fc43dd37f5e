"""Value and colour detection helpers.

Counterpart of :mod:`darsia_tpu.utils.detection`.  The comparisons run on
the image's device (a numpy input goes to ``device``, the CUDA card when
None); the voxel arrays returned are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.image import as_tensor
from .point import VoxelArray, make_voxel

__all__ = [
    "detect_value",
    "detect_color",
    "orthogonal_colors",
    "monochromatic_concentration_analysis",
    "detect_closest_point",
]


def _data(img, device) -> torch.Tensor:
    return as_tensor(img.img if hasattr(img, "img") else img, device)


def _voxels(hits: torch.Tensor) -> VoxelArray:
    return make_voxel(torch.nonzero(hits).cpu().numpy())


def detect_value(img, value: float, tolerance: float = 0.01, device=None) -> VoxelArray:
    """Voxels where a scalar image is within tolerance of a value."""
    data = _data(img, device)
    return _voxels(torch.abs(data - value) < tolerance)


def detect_color(img, color, tolerance: float = 0.01, device=None) -> VoxelArray:
    """Voxels where an RGB image matches a color within tolerance (the
    distance in float64 where ``color`` is, as numpy promotes it; an integer
    difference, such as a uint8 image against an integer colour, is measured
    in float64 as numpy's norm measures it)."""
    data = _data(img, device)
    color = torch.as_tensor(np.asarray(color), device=data.device)
    diff = data - color
    if not diff.is_floating_point():
        diff = diff.to(torch.float64)
    distance = torch.linalg.vector_norm(diff, dim=-1)
    return _voxels(distance < tolerance)


def orthogonal_colors(color: np.ndarray) -> np.ndarray:
    """Two colors spanning the plane orthogonal to ``color`` in RGB space."""
    color = np.asarray(color, dtype=float)
    n = color / max(np.linalg.norm(color), 1e-12)
    # Gram-Schmidt: orthogonalize two canonical axes against the color.
    candidates = np.eye(3)
    # Pick the two axes least aligned with the color.
    alignment = np.abs(candidates @ n)
    picks = np.argsort(alignment)[:2]
    basis = []
    for idx in picks:
        v = candidates[idx] - (candidates[idx] @ n) * n
        for b in basis:
            v = v - (v @ b) * b
        v = v / max(np.linalg.norm(v), 1e-12)
        basis.append(v)
    out = np.array(basis) * np.linalg.norm(color)
    # Normalize into the unit color cube.
    out = np.abs(out)
    max_per_row = np.maximum(out.max(axis=1, keepdims=True), 1e-12)
    return out / max_per_row


def monochromatic_concentration_analysis(img, color):
    """Concentration analysis projecting onto a single color direction."""
    from ..analysis.concentrationanalysis import ConcentrationAnalysis
    from ..signals.models.kernelinterpolation import KernelInterpolation
    from .kernels import LinearKernel

    ortho = orthogonal_colors(np.asarray(color))
    analysis = ConcentrationAnalysis(
        model=KernelInterpolation(
            kernel=LinearKernel(),
            supports=np.vstack((color, ortho)),
            values=[1, 0, 0],
        )
    )
    return analysis(img)


def detect_closest_point(points, target):
    """The point in ``points`` closest to ``target`` (same flavour)."""
    distances = np.linalg.norm(np.asarray(points) - np.asarray(target), axis=1)
    return points[int(np.argmin(distances))]
