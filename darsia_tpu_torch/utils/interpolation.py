"""Scattered-data interpolation onto physical images.

Counterpart of :mod:`darsia_tpu.utils.interpolation`.  :func:`rbf_interpolate`
is the thin-plate spline of the registration: the JAX function solves and
evaluates in float32 at pixel scale, where the r^2 log r kernel reaches ~1e7
and cancels to a few pixels.  Here the (N + 3)^2 system is solved in float64
on the host, in coordinates scaled by 1 / max |points|, and evaluated in
float64 in blocks on the query's device.  The rescale is exact: sum_i w_i
r_i^2 is constant in the query point by the TPS side conditions (sum w = 0,
sum w p = 0), so the scaled interpolant equals the unscaled one; only the
conditioning changes.

The fits onto an image's voxel grid (polynomial, point-source illumination)
are the JAX package's float64 numpy computations on the host; the result is
a float32 tensor on the image's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np
import torch

from ..image.image import as_tensor

__all__ = [
    "illumination_interpolation",
    "interpolate_measurements_2d",
    "interpolate_to_image",
    "interpolate_to_image_from_csv",
    "polynomial_design_matrix",
    "polynomial_interpolation",
    "rbf_interpolate",
]

#: Queries evaluated per block: a (block, N) float64 kernel matrix at a time.
_BLOCK = 1 << 16


def _tps_kernel(r):
    """Thin-plate kernel r^2 log r (numpy or torch)."""
    if isinstance(r, torch.Tensor):
        safe = torch.where(r > 0, r, torch.ones_like(r))
        return torch.where(r > 0, r * r * torch.log(safe), torch.zeros_like(r))
    safe = np.where(r > 0, r, 1.0)
    return np.where(r > 0, r * r * np.log(safe), 0.0)


def rbf_interpolate(points, values, query, smoothing: float = 0.0) -> torch.Tensor:
    """Thin-plate-spline RBF interpolation.

    Args:
        points: (N, 2) sample locations (numpy or sequence).
        values: (N,) sample values.
        query: (M, 2) evaluation locations: a tensor (evaluated on its
            device) or a numpy array (evaluated on the CPU).
        smoothing: Tikhonov smoothing on the kernel diagonal (in the
            caller's units).

    Returns:
        (M,) float32 tensor on the query's device.

    """
    P = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    n = P.shape[0]
    scale = 1.0 / max(float(np.abs(P).max()), np.finfo(np.float64).tiny)
    Pn = P * scale
    K = _tps_kernel(np.linalg.norm(Pn[:, None, :] - Pn[None, :, :], axis=-1))
    # The kernel scales by s^2 under the rescale, so the smoothing does too.
    K = K + smoothing * scale**2 * np.eye(n)
    poly = np.concatenate([np.ones((n, 1)), Pn], axis=1)
    A = np.block([[K, poly], [poly.T, np.zeros((3, 3))]])
    sol = np.linalg.solve(A, np.concatenate([v, np.zeros(3)]))

    Q = torch.as_tensor(query)
    device = Q.device
    Q = Q.reshape(-1, 2).to(torch.float64) * scale
    Pt = torch.from_numpy(Pn).to(device)
    w = torch.from_numpy(sol[:n]).to(device)
    c = torch.from_numpy(sol[n:]).to(device)
    p_sq = (Pt * Pt).sum(-1)
    out = []
    for Qb in Q.split(_BLOCK):
        # The matmul distance trick: no (block, N, 2) broadcast.
        d2 = ((Qb * Qb).sum(-1, keepdim=True) - 2.0 * (Qb @ Pt.T) + p_sq).clamp(min=0.0)
        out.append(_tps_kernel(d2.sqrt()) @ w + c[0] + Qb @ c[1:])
    return torch.cat(out).to(torch.float32)


def polynomial_design_matrix(coords: np.ndarray, degree: int) -> np.ndarray:
    """Monomial design matrix x^i y^j for i + j <= degree."""
    coords = np.asarray(coords, dtype=float)
    cols = [
        coords[:, 0] ** i * coords[:, 1] ** j
        for i in range(degree + 1)
        for j in range(degree + 1)
        if i + j <= degree
    ]
    return np.stack(cols, axis=1)


def _grid_values(values, coordinate_system) -> np.ndarray:
    """Values listed in the coordinate system's (column-major) voxel order,
    as an array of its shape."""
    return np.asarray(values).reshape(coordinate_system.shape, order="F")


def interpolate_measurements_2d(measurements, coordinate_system, device=None) -> torch.Tensor:
    """TPS-interpolate (x, y, values) measurements onto a voxel grid; the
    spline is evaluated on ``device`` (the image's, for an image's grid; by
    default the CUDA card)."""
    if len(measurements) != 3:
        raise ValueError("measurements are (x, y, values)")
    points = np.stack([measurements[0], measurements[1]], axis=1)
    coords = as_tensor(np.asarray(coordinate_system.coordinates, dtype=float), device)
    out = rbf_interpolate(points, measurements[2], coords)
    # Column-major voxel order: the transposed grid, read row-major.
    return out.reshape(tuple(coordinate_system.shape)[::-1]).T


def polynomial_interpolation(measurements, coordinate_system, degree: int = 2) -> np.ndarray:
    """Least-squares polynomial fit of measurements, evaluated on the grid.

    The degree is capped so the fit stays overdetermined.
    """
    points = np.stack([measurements[0], measurements[1]], axis=1)
    while degree > 0 and (degree + 1) * (degree + 2) // 2 > points.shape[0]:
        degree -= 1
    X = polynomial_design_matrix(points, degree)
    coeffs, *_ = np.linalg.lstsq(X, np.asarray(measurements[2], dtype=float), rcond=None)
    Xq = polynomial_design_matrix(np.asarray(coordinate_system.coordinates, dtype=float), degree)
    return _grid_values(Xq @ coeffs, coordinate_system)


def illumination_interpolation(measurements, coordinate_system) -> np.ndarray:
    """Point-source illumination model fit, ``I0 / dist(p, source)^p``."""
    from scipy.optimize import least_squares

    points = np.stack([measurements[0], measurements[1]], axis=1)
    data = np.asarray(measurements[2], dtype=float)

    def model(coeffs, coords):
        dist = (
            np.sqrt(
                (coords[:, 0] - coeffs[0]) ** 2
                + (coords[:, 1] - coeffs[1]) ** 2
                + coeffs[2] ** 2
            )
            ** coeffs[4]
        )
        return coeffs[3] / dist

    result = least_squares(lambda c: model(c, points) - data, np.ones(5))
    coords = np.asarray(coordinate_system.coordinates, dtype=float)
    return _grid_values(model(result.x, coords), coordinate_system)


def interpolate_to_image(
    data,
    image,
    method: Literal["rbf", "illumination", "linear", "quadratic", "cubic", "quartic"] = "rbf",
):
    """Scattered (x, y, value) data interpolated onto an image's voxel grid:
    a copy of ``image`` holding the float32 result on its device."""
    if len(data) != 3:
        raise ValueError("Data must be a tuple of (x, y, data).")
    if all(np.asarray(d).ndim == 2 for d in data):
        data = tuple(np.ravel(d) for d in data)
    interpolated = image.copy()
    cs = interpolated.coordinatesystem
    device = interpolated.device
    method = method.lower()
    if method == "rbf":
        values = interpolate_measurements_2d(data, cs, device)
    elif method == "illumination":
        values = illumination_interpolation(data, cs)
    elif method in ("linear", "quadratic", "cubic", "quartic"):
        degree = {"linear": 1, "quadratic": 2, "cubic": 3, "quartic": 4}[method]
        values = polynomial_interpolation(data, cs, degree)
    else:
        raise NotImplementedError(f"Interpolation method {method!r} not supported.")
    interpolated.img = torch.as_tensor(values, dtype=torch.float32).to(device).contiguous()
    return interpolated


def interpolate_to_image_from_csv(csv_file: Path, key: str, image, method: str = "rbf"):
    """Interpolate measurement columns of a CSV file (a header row naming
    x or X, y or Y, and ``key``) onto an image."""
    import csv

    with open(Path(csv_file), newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    header = [name.strip() for name in rows[0]]
    table = np.array(rows[1:], dtype=float)

    def column(name: str) -> np.ndarray:
        return table[:, header.index(name)]

    x_key = "x" if "x" in header else "X"
    y_key = "y" if "y" in header else "Y"
    return interpolate_to_image(
        (column(x_key), column(y_key), column(key)), image, method=method
    )
