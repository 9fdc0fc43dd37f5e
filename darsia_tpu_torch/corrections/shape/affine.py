"""Affine (similarity) transformations: translation + rotation + scaling.

Counterpart of :mod:`darsia_tpu.corrections.shape.affine`: the closed-form
least-squares similarity fit (Procrustes/Kabsch: centroids, SVD, optional
scale) and the parameter API, float64 numpy on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from ...image.indexing import interpret_indexing
from ...utils.npz import load_npz
from .transformation import BaseTransformation, TransformationCorrection

__all__ = ["AffineTransformation", "AffineCorrection"]


def _rotvec_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rotation matrix from a rotation vector (Rodrigues), host-side."""
    theta = float(np.linalg.norm(rotvec))
    if theta < 1e-15:
        return np.eye(3)
    k = np.asarray(rotvec, dtype=float) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=float)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def axis_rotations(rotations, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(rotation, inverse) of a sequence of ``(angle, cartesian_axis)`` turns
    in 3-D, composed in order."""
    rotation, rotation_inv = np.eye(3), np.eye(3)
    for degree, cartesian_axis in rotations:
        matrix_axis, reverted = interpret_indexing(cartesian_axis, "xyz"[:dim])
        vector = np.eye(3)[matrix_axis]
        flip = -1.0 if reverted else 1.0
        rotation = rotation @ _rotvec_matrix(flip * degree * vector)
        rotation_inv = rotation_inv @ _rotvec_matrix(-degree * vector)
    return rotation, rotation_inv


def plane_rotation(angle: float) -> tuple[np.ndarray, np.ndarray]:
    """(rotation, inverse) of a 2-D turn by ``angle`` radians."""
    axis = np.array([0.0, 0.0, 1.0])
    return _rotvec_matrix(angle * axis)[:2, :2], _rotvec_matrix(-angle * axis)[:2, :2]


class AffineTransformation(BaseTransformation):
    """Similarity map ``x -> translation + scaling * R x``."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dim = dim
        self.translation = np.zeros(dim, dtype=float)
        self.scaling = 1.0
        self.rotation = np.eye(dim)
        self.rotation_inv = np.eye(dim)
        self.isometry = False

    # --------------------------------------------------------------- params

    def set_parameters(
        self,
        translation: Optional[np.ndarray] = None,
        scaling: Optional[float] = None,
        rotation: Optional[np.ndarray] = None,
    ) -> None:
        """Set parameters; rotation given as angle(s) in radians (1 in 2d,
        3 per-Cartesian-axis angles in 3d)."""
        if translation is not None:
            self.translation = np.asarray(translation, dtype=float)
        if scaling is not None:
            self.scaling = float(scaling)
        if rotation is not None:
            if len(rotation) != (1 if self.dim == 2 else 3):
                raise ValueError(f"{len(rotation)} rotation angles in {self.dim}-D")
            if self.dim == 2:
                self.rotation, self.rotation_inv = plane_rotation(rotation[0])
            elif self.dim == 3:
                self.rotation, self.rotation_inv = axis_rotations(
                    zip(rotation, "xyz"), self.dim
                )

    def set_parameters_as_vector(self, parameters: np.ndarray) -> None:
        num_rot = 1 if self.dim == 2 else self.dim
        want = self.dim + num_rot + (0 if self.isometry else 1)
        if len(parameters) != want:
            raise ValueError(f"{len(parameters)} parameters, need {want}")
        translation = parameters[: self.dim]
        scaling = 1.0 if self.isometry else parameters[self.dim]
        rotation = parameters[-num_rot:]
        self.set_parameters(translation, scaling, rotation)

    # ------------------------------------------------------------------ fit

    def fit(self, pts_src, pts_dst, fit_options: Optional[dict] = None) -> bool:
        """Closed-form least-squares similarity fit (Procrustes/Kabsch)."""
        fit_options = fit_options or {}
        if pts_src.shape != pts_dst.shape or pts_src.shape[1] != self.dim:
            raise ValueError(f"point pairs {pts_src.shape}, {pts_dst.shape} in {self.dim}-D")
        self.set_dtype(pts_src, pts_dst)
        self.isometry = fit_options.get("isometry", False)

        src = np.asarray(pts_src, dtype=float)
        dst = np.asarray(pts_dst, dtype=float)
        c_src = src.mean(axis=0)
        c_dst = dst.mean(axis=0)
        src0 = src - c_src
        dst0 = dst - c_dst

        # Cross-covariance and SVD; det correction keeps a proper rotation.
        H = src0.T @ dst0
        U, S, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag(np.append(np.ones(self.dim - 1), d))
        R = Vt.T @ D @ U.T

        if self.isometry:
            scale = 1.0
        else:
            var_src = np.sum(src0**2)
            scale = float(np.sum(S * np.diag(D)) / var_src) if var_src > 0 else 1.0

        self.rotation = R
        self.rotation_inv = R.T
        self.scaling = scale
        self.translation = c_dst - scale * (R @ c_src)
        return True

    # ---------------------------------------------------------- application

    def call_array(self, x: np.ndarray) -> np.ndarray:
        if x.shape[1] != self.dim:
            raise ValueError(f"points of shape {x.shape} in {self.dim}-D")
        return self.translation + self.scaling * (self.rotation @ x.T).T

    def inverse_array(self, x: np.ndarray) -> np.ndarray:
        if x.shape[1] != self.dim:
            raise ValueError(f"points of shape {x.shape} in {self.dim}-D")
        return (self.rotation_inv @ ((x - self.translation) / self.scaling).T).T


class AffineCorrection(TransformationCorrection):
    """Image correction from an affine transformation fit to point pairs.

    A saved correction holds the transformation only: read it with
    ``AffineCorrection(cs_src, cs_dst).load(path)``.  ``read_correction``
    cannot (it has no coordinate systems to give), as in the JAX package.
    """

    def __init__(
        self,
        coordinatesystem_src,
        coordinatesystem_dst,
        pts_src=None,
        pts_dst=None,
        fit_options: Optional[dict] = None,
    ) -> None:
        transformation = AffineTransformation(coordinatesystem_src.dim)
        if pts_src is not None and pts_dst is not None:
            transformation.fit(pts_src, pts_dst, fit_options)
        super().__init__(coordinatesystem_src, coordinatesystem_dst, transformation)

    def save(self, path: Union[str, Path]) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        t = self.transformation
        np.savez(
            path,
            class_name=type(self).__name__,
            translation=t.translation,
            scaling=t.scaling,
            rotation=t.rotation,
            rotation_inv=t.rotation_inv,
            isometry=t.isometry,
        )

    def load(self, path: Union[str, Path]) -> None:
        if not hasattr(self, "transformation"):
            raise ValueError(
                "an AffineCorrection file holds no coordinate systems: construct "
                "AffineCorrection(coordinatesystem_src, coordinatesystem_dst) and "
                "call its load(path)"
            )
        data = load_npz(path)
        t = self.transformation
        t.translation = data["translation"]
        t.scaling = float(data["scaling"])
        t.rotation = data["rotation"]
        t.rotation_inv = data["rotation_inv"]
        t.isometry = bool(data["isometry"])
        self._cache = {}
