"""Polynomial approximation spaces and linear least-squares approximations.

Counterpart of :mod:`darsia_tpu.utils.approximations`: float64 numpy on the
host.  :meth:`LinearApproximation.evaluate_on` also evaluates the field over
a whole coordinate system on a device, as one float64 ``(N, S) @ (S, V)``
product cast to float32, where the host path adds ``S`` outer products of
``N x V`` float64.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Literal, Optional, Union

import numpy as np
import torch

__all__ = [
    "ApproximationSpace",
    "PolynomialApproximationSpace",
    "RadialPolynomialApproximationSpace",
    "LinearApproximation",
]


class ApproximationSpace(ABC):
    """Abstract basis of scalar functions over 2d points.  ``basis`` takes
    ``(..., 2)`` points as a numpy array or a tensor."""

    @property
    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def basis(self, x, i: int): ...

    def __call__(self, x: np.ndarray) -> list:
        return [self.basis(x, i) for i in range(self.size)]


class PolynomialApproximationSpace(ApproximationSpace):
    """Tensor polynomial basis x^i y^j (indexing as in the JAX package)."""

    def __init__(self, degree: int) -> None:
        self.degree = degree

    @property
    def size(self) -> int:
        return (self.degree + 1) * (self.degree + 2) // 2

    def basis(self, x, k: int):
        i, j = divmod(k, self.degree + 1)
        return x[..., 0] ** i * x[..., 1] ** j


class RadialPolynomialApproximationSpace(ApproximationSpace):
    """Radial basis |x - center|^i, i <= degree."""

    def __init__(self, degree: int, center: Optional[np.ndarray] = None) -> None:
        self.degree = degree
        self.center = center if center is not None else np.zeros(2)

    def set_center(self, center: np.ndarray) -> None:
        self.center = center

    @property
    def size(self) -> int:
        return self.degree + 1

    def basis(self, x, i: int):
        if isinstance(x, torch.Tensor):
            center = torch.as_tensor(np.asarray(self.center), dtype=x.dtype, device=x.device)
            return torch.linalg.norm(x - center, dim=-1) ** i
        return np.linalg.norm(x - self.center, axis=-1) ** i


class LinearApproximation:
    """Linear combination over an approximation space with tensor values."""

    def __init__(
        self,
        space: ApproximationSpace,
        dim: Union[int, tuple],
        domain: Literal["voxels", "coordinates"] = "coordinates",
    ) -> None:
        self.space = space
        self.shape = (space.size, dim) if isinstance(dim, int) else (space.size, *dim)
        self.size = int(np.prod(self.shape))
        self.domain = domain
        self.coefficients = np.zeros(self.shape, dtype=float)

    def _points(self, coordinatesystem) -> np.ndarray:
        """The coordinate system's voxels or coordinates (column-major)."""
        if self.domain == "voxels":
            return np.asarray(coordinatesystem.voxels, dtype=float)
        return np.asarray(coordinatesystem.coordinates, dtype=float)

    def evaluate(self, inputs) -> np.ndarray:
        """Evaluate at points or over a whole coordinate system (host).

        Returns an array of shape (*points_shape, *value_shape).
        """
        from ..image.coordinatesystem import CoordinateSystem

        if isinstance(inputs, CoordinateSystem):
            out = self._evaluate_points(self._points(inputs))
            return out.reshape((*inputs.shape, *self.shape[1:]), order="F")
        return self._evaluate_points(np.asarray(inputs, dtype=float))

    def evaluate_on(self, coordinatesystem, device) -> torch.Tensor:
        """The field over a whole coordinate system, evaluated on ``device``.

        Returns a float32 tensor of shape (*coordinatesystem.shape,
        *value_shape), equal to :meth:`evaluate` within float32 rounding.
        """
        pts = torch.from_numpy(self._points(coordinatesystem)).to(device)
        design = torch.stack([self.space.basis(pts, i) for i in range(self.space.size)], dim=1)
        coefficients = torch.from_numpy(
            np.asarray(self.coefficients, dtype=np.float64).reshape(self.space.size, -1)
        ).to(device)
        flat = (design @ coefficients).to(torch.float32)
        # The points are listed in column-major order of the voxel grid: the
        # ``order="F"`` reshape of ``evaluate`` reverses the spatial axes.
        spatial = tuple(coordinatesystem.shape)
        grid = flat.reshape(*reversed(spatial), *self.shape[1:])
        dims = tuple(reversed(range(len(spatial))))
        rest = tuple(range(len(spatial), grid.dim()))
        return grid.permute(*dims, *rest).contiguous()

    def _evaluate_points(self, pts: np.ndarray) -> np.ndarray:
        value_size = int(np.prod(self.shape[1:]))
        flat = np.zeros((len(pts), value_size))
        for i in range(self.space.size):
            flat += np.outer(self.space.basis(pts, i), np.ravel(self.coefficients[i]))
        return flat.reshape((len(pts), *self.shape[1:]))

    def fit(self, pts: np.ndarray, values: np.ndarray) -> None:
        """Closed-form LS fit of the coefficients from point samples."""
        pts = np.asarray(pts, dtype=float)
        design = np.stack([self.space.basis(pts, i) for i in range(self.space.size)], axis=1)
        value_size = int(np.prod(self.shape[1:]))
        target = np.asarray(values, dtype=float).reshape(len(pts), value_size)
        sol, *_ = np.linalg.lstsq(design, target, rcond=None)
        self.coefficients = sol.reshape(self.shape)
