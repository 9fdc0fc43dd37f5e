"""Unified Wasserstein distance interface.

Counterpart of :mod:`darsia_tpu.measure.wasserstein` (reference
``src/darsia/measure/wasserstein.py``).  The finite-volume solvers run on
the images' device: the CUDA card for images built from numpy;
``method="cv2.emd"`` solves the exact transport problem on the host
(:class:`darsia_tpu_torch.measure.emd.EMD`).
"""

from __future__ import annotations

from pathlib import Path

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
            solvers) or "cv2.emd" (OpenCV's exact solve on the host, no
            weight).  "sharded_newton" is the JAX package's other method; it
            raises here (see below).
        weight: optional cell weight image (anisotropic metric); a numpy
            weight goes to the images' device.
        kwargs: ``options`` dict for the solvers; ``preprocess`` for
            "cv2.emd".

    Raises:
        NotImplementedError: "sharded_newton" (the domain-decomposed solve
            over several devices is not ported: ROADMAP.md, Queue 1, item 8),
            or an unknown method.
        ImportError: "cv2.emd" where OpenCV does not import.
    """
    method_name = method.lower()
    if method_name == "sharded_newton":
        raise NotImplementedError(
            "sharded_newton is not ported: the domain-decomposed solve over "
            "several devices (darsia_tpu.parallel.beckmann) waits for the "
            "multi-GPU port (ROADMAP.md, Queue 1, item 8); use method='newton'"
        )
    if method_name == "cv2.emd":
        assert weight is None, "Weighted EMD not supported by cv2."
        return EMD(kwargs.get("preprocess"))(mass_src, mass_dst)
    if method_name not in _SOLVERS:
        raise NotImplementedError(f"Method {method_name} not implemented.")
    grid = generate_grid(mass_dst)
    solver = _SOLVERS[method_name](grid, weight, kwargs.get("options", {}))
    return solver(mass_src, mass_dst)


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
    """Export a Wasserstein info dict to a legacy VTK file: not ported."""
    from ..image.image import _absent

    raise _absent("wasserstein_distance_to_vtk", "a VTK writer")
