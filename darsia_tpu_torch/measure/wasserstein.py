"""Unified Wasserstein distance interface.

Counterpart of :mod:`darsia_tpu.measure.wasserstein` (reference
``src/darsia/measure/wasserstein.py``).  The finite-volume solvers run on
the images' device: the CUDA card for images built from numpy;
``method="cv2.emd"`` solves the exact transport problem on the host
(:class:`darsia_tpu_torch.measure.emd.EMD`); ``method="sharded_newton"``
solves over the devices of ``options["mesh"]``
(:func:`darsia_tpu_torch.parallel.beckmann.sharded_beckmann_newton`).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..utils.grid import generate_grid
from .beckmann import (
    BeckmannBregmanSolver,
    BeckmannGproxPGHDSolver,
    BeckmannNewtonSolver,
)
from .emd import EMD

__all__ = [
    "wasserstein_distance",
    "wasserstein_distance_3d",
    "wasserstein_distance_to_vtk",
]

_SOLVERS = {
    "newton": BeckmannNewtonSolver,
    "bregman": BeckmannBregmanSolver,
    "gprox": BeckmannGproxPGHDSolver,
}


def wasserstein_distance(
    mass_src,
    mass_dst,
    method: str = "newton",
    weight=None,
    **kwargs,
):
    """Wasserstein-1 distance between two equal-mass images.

    Args:
        mass_src / mass_dst: source/destination distributions (scalar Images).
        method: "newton" | "bregman" | "gprox" (the finite-volume Beckmann
            solvers), "sharded_newton" (domain-decomposed over
            ``options["mesh"]``, a :class:`darsia_tpu_torch.parallel.Mesh`;
            the other options go to ``sharded_beckmann_newton``) or
            "cv2.emd" (OpenCV's exact solve on the host, no weight).
        weight: optional cell weight image (anisotropic metric); a numpy
            weight goes to the images' device.
        kwargs: ``options`` dict for the solvers; ``preprocess`` for
            "cv2.emd".

    Raises:
        ValueError: "sharded_newton" without ``options["mesh"]``.
        NotImplementedError: an unknown method.
        ImportError: "cv2.emd" where OpenCV does not import.
    """
    method_name = method.lower()
    if method_name == "sharded_newton":
        return _sharded_newton(mass_src, mass_dst, weight, dict(kwargs.get("options", {})))
    if method_name == "cv2.emd":
        assert weight is None, "Weighted EMD not supported by cv2."
        return EMD(kwargs.get("preprocess"))(mass_src, mass_dst)
    if method_name not in _SOLVERS:
        raise NotImplementedError(f"Method {method_name} not implemented.")
    grid = generate_grid(mass_dst)
    solver = _SOLVERS[method_name](grid, weight, kwargs.get("options", {}))
    return solver(mass_src, mass_dst)


def _sharded_newton(mass_src, mass_dst, weight, options: dict):
    """The domain-decomposed solve on dst - src (the single-device sign
    convention, so the pressure agrees across methods)."""
    from ..parallel.beckmann import sharded_beckmann_newton

    mesh = options.pop("mesh", None)
    if mesh is None:
        raise ValueError(
            'sharded_newton requires options["mesh"] = '
            "darsia_tpu_torch.parallel.create_mesh(...) naming the devices to shard over."
        )
    return_info = options.pop("return_info", False)
    grid = generate_grid(mass_dst)
    solve = sharded_beckmann_newton(
        mesh,
        tuple(int(s) for s in grid.shape),
        voxel_size=list(grid.voxel_size),
        weight=weight,
        **options,
    )
    diff = mass_dst.img.to(torch.float32) - mass_src.img.to(torch.float32)
    if return_info:
        distance, fluxes, pressure, iterations = solve(diff, return_fluxes=True)
        return float(distance), {
            "pressure": pressure,
            "flux": fluxes,
            "number_iterations": int(iterations),
        }
    distance, _, _ = solve(diff)
    return float(distance)


def wasserstein_distance_3d(mass_src, mass_dst, **kwargs):
    """Wasserstein-1 distance for 3-D images.

    The reference's paper workflow calls ``wasserstein_distance_3d``, which
    the upstream package never defines; the Beckmann solvers are
    dimension-generic, so this entry point forwards.
    """
    if getattr(mass_dst, "space_dim", 3) != 3:
        raise ValueError("wasserstein_distance_3d expects 3-D images.")
    return wasserstein_distance(mass_src, mass_dst, **kwargs)


def wasserstein_distance_to_vtk(path: Path, info: dict) -> None:
    """Export a Wasserstein info dict (``return_info``) to a legacy VTK file:
    the images and scalar fields, the fluxes as vectors, the weights'
    first component."""
    from ..utils.formats import Format
    from ..utils.plotting import to_vtk

    data = [
        (key, info[key], fmt)
        for key, fmt in [
            ("src", Format.SCALAR),
            ("dst", Format.SCALAR),
            ("mass_diff", Format.SCALAR),
            ("flux", Format.VECTOR),
            ("weighted_flux", Format.VECTOR),
            ("pressure", Format.SCALAR),
            ("transport_density", Format.SCALAR),
            ("weight", Format.TENSOR),
            ("weight_inv", Format.TENSOR),
        ]
        if key in info
    ]
    to_vtk(path, data)
