"""Generalized perspective transformation (perspective + bulge + stretch).

Counterpart of :mod:`darsia_tpu.corrections.shape.generalizedperspective`:
the transformation formulas and the staged Levenberg-Marquardt least-squares
fit of its parameters, float64 numpy and scipy on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...utils.point import Voxel
from .transformation import BaseTransformation, TransformationCorrection

__all__ = [
    "GeneralizedPerspectiveTransformation",
    "GeneralizedPerspectiveCorrection",
]


class GeneralizedPerspectiveTransformation(BaseTransformation):
    """Perspective + bulge + stretch map for 2d images (16 parameters)."""

    def __init__(self) -> None:
        super().__init__()
        self.A = np.array([1, 0, 0, 1], dtype=float).reshape((2, 2))
        self.b = np.zeros(2, dtype=float)
        self.c = np.zeros(2, dtype=float)
        self.stretch_factor = np.zeros(2, dtype=float)
        self.stretch_center_off = np.zeros(2, dtype=float)
        self.bulge_factor = np.zeros(2, dtype=float)
        self.bulge_center_off = np.zeros(2, dtype=float)
        self.default_parameters = np.concatenate(
            (
                self.A.flatten(),
                self.b,
                self.c,
                self.stretch_factor,
                self.stretch_center_off,
                self.bulge_factor,
                self.bulge_center_off,
            )
        )

    def set_parameters_as_vector(self, parameters: np.ndarray) -> None:
        if len(parameters) > len(self.default_parameters):
            raise ValueError(f"{len(parameters)} parameters, at most 16")
        self.A = np.asarray(parameters[:4], dtype=float).reshape((2, 2))
        self.b = np.asarray(parameters[4:6], dtype=float)
        self.c = np.asarray(parameters[6:8], dtype=float)
        if len(parameters) > 8:
            self.stretch_factor = np.asarray(parameters[8:10], dtype=float)
            self.stretch_center_off = np.asarray(parameters[10:12], dtype=float)
        if len(parameters) > 12:
            self.bulge_factor = np.asarray(parameters[12:14], dtype=float)
            self.bulge_center_off = np.asarray(parameters[14:16], dtype=float)

    def call_array(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError("Forward evaluation not implemented")

    def inverse_array(self, x: np.ndarray) -> np.ndarray:
        x_arr = np.asarray(x, dtype=float).T

        # Perspective part.
        out = self.A @ x_arr
        out[0] += self.b[0]
        out[1] += self.b[1]
        scaling = (self.c @ x_arr) + 1
        out = out / scaling

        # Bulge part.
        rel = out.copy()
        rel[0] -= self.center[0] + self.bulge_center_off[0]
        rel[1] -= self.center[1] + self.bulge_center_off[1]
        rel_max = self.max_coordinate - self.center - self.bulge_center_off
        rel_min = self.min_coordinate - self.center - self.bulge_center_off
        bulge = np.zeros_like(out)
        bulge[0] = self.bulge_factor[0] * rel[0] * (rel_max[0] - rel[0]) * (
            rel[0] - rel_min[0]
        )
        bulge[1] = self.bulge_factor[1] * rel[1] * (rel_max[1] - rel[1]) * (
            rel[1] - rel_min[1]
        )
        out = out + bulge

        # Stretch part (note: multiplicative center offset, as in the JAX package).
        rel = out.copy()
        rel[0] -= self.center[0] * self.stretch_center_off[0]
        rel[1] -= self.center[1] * self.stretch_center_off[1]
        rel_max = self.max_coordinate - self.center - self.stretch_center_off
        rel_min = self.min_coordinate - self.center - self.stretch_center_off
        stretch = np.zeros_like(out)
        stretch[0] = self.stretch_factor[0] * rel[0] * (rel_max[1] - rel[1]) * (
            rel[1] - rel_min[1]
        )
        stretch[1] = self.stretch_factor[1] * rel[1] * (rel_max[0] - rel[0]) * (
            rel[0] - rel_min[0]
        )
        out = out + stretch

        return out.T

    def fit(self, pts_src, pts_dst, fit_options: Optional[dict] = None):
        """Fit the inverse transformation to point pairs (staged LM solve)."""
        from scipy import optimize

        fit_options = fit_options or {}
        coordinatesystem_dst = fit_options.get("coordinatesystem_dst")
        if coordinatesystem_dst is None:
            raise ValueError("fit_options needs coordinatesystem_dst")
        maxiter = fit_options.get("maxiter", 100)
        tol = fit_options.get("tol", 1e-5)
        strategy = fit_options.get("strategy", ["all"])

        self.set_dtype(pts_src, pts_dst)
        self.max_coordinate = (
            np.array(coordinatesystem_dst.shape, dtype=float)
            if self.output_dtype == Voxel
            else np.asarray(coordinatesystem_dst.max_coordinate, dtype=float)
        )
        self.min_coordinate = (
            np.zeros(2, dtype=float)
            if self.output_dtype == Voxel
            else np.asarray(coordinatesystem_dst.min_coordinate, dtype=float)
        )
        self.center = 0.5 * (self.max_coordinate + self.min_coordinate)

        self.initial_parameters = self.default_parameters.copy()
        src = np.asarray(pts_src, dtype=float)
        dst = np.asarray(pts_dst, dtype=float)

        result = None
        for item in strategy:
            if item == "perspective":
                ids = np.arange(8)
            elif item == "perspective+bulge":
                ids = np.arange(12)
            elif item == "all":
                ids = np.arange(len(self.initial_parameters))
            else:
                raise ValueError(f"Unknown strategy {item}")

            def residuals(params: np.ndarray) -> np.ndarray:
                full = self.initial_parameters.copy()
                full[ids] = params
                self.set_parameters_as_vector(full)
                warped = self.inverse_array(dst)
                reg = 1e-4 * (params - self.initial_parameters[ids])
                return np.concatenate(((warped - src).ravel(), reg))

            result = optimize.least_squares(
                residuals,
                self.initial_parameters[ids],
                method="lm",
                xtol=tol,
                max_nfev=maxiter * (len(ids) + 1),
            )
            self.initial_parameters[ids] = result.x

        self.set_parameters_as_vector(self.initial_parameters)
        return result


class GeneralizedPerspectiveCorrection(TransformationCorrection):
    """Image correction from a generalized perspective transformation.

    It cannot be saved: ``save`` and ``load`` raise ``NotImplementedError``,
    as in the JAX package.
    """

    def __init__(
        self,
        coordinatesystem_src,
        coordinatesystem_dst,
        pts_src,
        pts_dst,
        fit_options: Optional[dict] = None,
    ) -> None:
        fit_options = dict(fit_options or {})
        fit_options["coordinatesystem_dst"] = coordinatesystem_dst
        transformation = GeneralizedPerspectiveTransformation()
        transformation.fit(pts_src, pts_dst, fit_options)
        super().__init__(coordinatesystem_src, coordinatesystem_dst, transformation)
        self.dst_dimensions = coordinatesystem_dst.dimensions
        self.dst_origin = coordinatesystem_dst._coordinate_of_origin_voxel

    def correct_metadata(self, metadata: Optional[dict] = None) -> dict:
        return {"dimensions": self.dst_dimensions, "origin": self.dst_origin}
