"""Gauss quadrature on reference cells and faces (numpy).

Counterpart of :mod:`darsia_tpu.utils.quadrature`, copied: tensor products
of ``numpy.polynomial.legendre.leggauss``; ``order`` p uses p+1 points per
axis, and "max" maps to order 4/3/2 in 1d/2d/3d.  The Beckmann solvers copy
the points and weights to a device once per device.
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = [
    "gauss",
    "gauss_lobatto",
    "gauss_reference_cell",
    "gauss_reference_face",
    "gauss_reference_boundary",
    "reference_cell_corners",
]

_MAX_ORDER = {1: 4, 2: 3, 3: 2}


def gauss(dim: int, order: Union[int, str]) -> tuple[np.ndarray, np.ndarray]:
    """Gauss points/weights on [-1, 1]^dim (tensor product)."""
    if order == "max":
        order = _MAX_ORDER[dim]
    pts_1d, w_1d = np.polynomial.legendre.leggauss(int(order) + 1)
    if dim == 1:
        return pts_1d, w_1d
    grids = np.meshgrid(*([pts_1d] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wgrids = np.meshgrid(*([w_1d] * dim), indexing="ij")
    weights = np.prod(np.stack([w.ravel() for w in wgrids], axis=1), axis=1)
    return pts, weights


def gauss_reference_cell(dim: int, order: Union[int, str]):
    """Quadrature on the unit cube [0, 1]^dim, weights normalized to 1."""
    pts, weights = gauss(dim, order)
    pts = (np.atleast_2d(pts).reshape(-1, dim) + 1.0) / 2.0
    weights = weights / np.sum(weights)
    return pts, weights


def gauss_reference_face(
    dim: int, axis: int, side: int = 0, order: Union[int, str] = "max"
):
    """Quadrature on one face of the unit cube, embedded in cell coords.

    The face is the (dim-1)-cube with coordinate ``axis`` fixed to
    ``side`` (0 or 1).  Points have shape (N, dim); weights are
    normalized to 1 (so integrating f over the face is mean(w*f) times
    the face area).  Supplies the "faces" half of the reference's
    quadrature module (``utils/quadrature.py``) — used e.g. for face-based
    L1 modes and flux reconstructions.
    """
    assert 0 <= axis < dim and side in (0, 1)
    if dim == 1:
        return np.array([[float(side)]]), np.array([1.0])
    face_pts, weights = gauss_reference_cell(dim - 1, order)
    face_pts = np.atleast_2d(face_pts).reshape(-1, dim - 1)
    pts = np.empty((face_pts.shape[0], dim))
    other = [d for d in range(dim) if d != axis]
    pts[:, axis] = float(side)
    for k, d in enumerate(other):
        pts[:, d] = face_pts[:, k]
    return pts, weights


def gauss_lobatto(dim: int, order: Union[int, str]):
    """Gauss-Lobatto points/weights on [-1, 1]^dim (tensor product).

    Includes the interval endpoints — useful when integrand evaluations at
    cell corners/faces are reused (e.g. subcell projections).  ``order`` p
    uses p+2 points per axis and is exact to polynomial degree 2p+1.
    """
    if order == "max":
        order = _MAX_ORDER[dim]
    n = int(order) + 2  # number of points per axis
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points per axis.")
    # Interior nodes: roots of P'_{n-1} = extrema of Legendre P_{n-1}.
    inner = (
        np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
        if n > 2
        else np.array([])
    )
    pts_1d = np.concatenate([[-1.0], np.sort(inner), [1.0]])
    # w_i = 2 / (n(n-1) P_{n-1}(x_i)^2)
    Pn1 = np.polynomial.legendre.Legendre.basis(n - 1)(pts_1d)
    w_1d = 2.0 / (n * (n - 1) * Pn1**2)
    if dim == 1:
        return pts_1d, w_1d
    grids = np.meshgrid(*([pts_1d] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wgrids = np.meshgrid(*([w_1d] * dim), indexing="ij")
    weights = np.prod(np.stack([w.ravel() for w in wgrids], axis=1), axis=1)
    return pts, weights


def gauss_reference_boundary(dim: int, order: Union[int, str] = "max"):
    """Quadrature over the whole boundary of the unit cube.

    Concatenates :func:`gauss_reference_face` rules for all ``2 * dim``
    faces; weights are normalized to 1 (uniform across faces), so a
    boundary integral of f is (sum of w*f) times the boundary measure.
    Feeds the ``face_quadrature`` L1 mode of the Beckmann solvers
    (reference analogue: the cell rules in
    ``src/darsia/measure/beckmann_problem.py:221-263``; the face rules
    here extend the reference's ``utils/quadrature.py`` cell-only tables).
    """
    pts_all, w_all = [], []
    for axis in range(dim):
        for side in (0, 1):
            pts, w = gauss_reference_face(dim, axis, side, order)
            pts_all.append(pts)
            w_all.append(w / (2 * dim))
    return np.concatenate(pts_all, axis=0), np.concatenate(w_all)


def reference_cell_corners(dim: int):
    """Corners of the unit cube with uniform weights."""
    from itertools import product

    corners = np.array(list(product([0.0, 1.0], repeat=dim)))
    if dim == 2:
        # Match the reference's corner ordering (counter-clockwise).
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    weights = np.ones(len(corners)) / len(corners)
    return corners, weights
