"""Measures on images: geometric integration and optimal transport."""

from .beckmann import (
    BeckmannBregmanSolver,
    BeckmannConvergenceCriteria,
    BeckmannConvergenceHistory,
    BeckmannGproxPGHDSolver,
    BeckmannNewtonSolver,
    BeckmannProblem,
    L1Mode,
    MobilityMode,
)
from .beckmann_linalg import (
    BeckmannAMGSolver,
    BeckmannCGSolver,
    BeckmannDirectSolver,
    BeckmannKSPFieldSplitSolver,
    BeckmannKSPSolver,
    BeckmannLinearSolver,
    BeckmannLinearSolverFactory,
    BeckmannLinearSolverType,
)
from .emd import EMD
from .integration import (
    ExtrudedGeometry,
    ExtrudedPorousGeometry,
    Geometry,
    PorousGeometry,
    WeightedGeometry,
)
from .wasserstein import (
    wasserstein_distance,
    wasserstein_distance_3d,
    wasserstein_distance_to_vtk,
)

__all__ = [
    "BeckmannAMGSolver",
    "BeckmannBregmanSolver",
    "BeckmannCGSolver",
    "BeckmannConvergenceCriteria",
    "BeckmannConvergenceHistory",
    "BeckmannDirectSolver",
    "BeckmannGproxPGHDSolver",
    "BeckmannKSPFieldSplitSolver",
    "BeckmannKSPSolver",
    "BeckmannLinearSolver",
    "BeckmannLinearSolverFactory",
    "BeckmannLinearSolverType",
    "BeckmannNewtonSolver",
    "BeckmannProblem",
    "EMD",
    "ExtrudedGeometry",
    "ExtrudedPorousGeometry",
    "Geometry",
    "L1Mode",
    "MobilityMode",
    "PorousGeometry",
    "WeightedGeometry",
    "wasserstein_distance",
    "wasserstein_distance_3d",
    "wasserstein_distance_to_vtk",
]
