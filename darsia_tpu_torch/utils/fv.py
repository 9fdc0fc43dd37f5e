"""Finite-volume operators on tensor grids.

Counterpart of :mod:`darsia_tpu.utils.fv`.  Two forms, as there:

* sparse-matrix classes (``FVDivergence``, ``FVMass``) with a ``.mat``
  attribute (scipy), for API compatibility and host-side checks;
* matrix-free functions on tensors (``face_to_cell``,
  ``cell_to_face_average`` and the face reconstructions), which run on the
  device of the flux they are given (a numpy flux goes to the CUDA card) and
  return tensors there.  The JAX package reconstructs on the host in float64
  numpy; here the arithmetic is the flux's dtype, equal within its rounding.

Flat face vectors use the grid's Fortran-order numbering
(:meth:`Grid.face_arrays`, :meth:`Grid.flat_flux`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from ..image.image import as_tensor
from .grid import Grid, _fortran_ravel

__all__ = [
    "FVDivergence",
    "FVMass",
    "FVTangentialFaceReconstruction",
    "FVFullFaceReconstruction",
    "face_to_cell",
    "cell_to_face_average",
    "tangential_face_components",
]


class FVDivergence:
    """Sparse FV divergence: flat fluxes -> integrated cell divergence."""

    def __init__(self, grid: Grid) -> None:
        div_data = np.concatenate(
            [
                grid.face_vol[d] * np.tile([1.0, -1.0], grid.num_faces_per_axis[d])
                for d in range(grid.dim)
            ]
        )
        div_row = np.concatenate(
            [np.ravel(grid.connectivity[grid.faces[d]]) for d in range(grid.dim)]
        )
        div_col = np.repeat(np.arange(grid.num_faces, dtype=int), 2)
        self.mat = sps.csc_matrix(
            (div_data, (div_row, div_col)),
            shape=(grid.num_cells, grid.num_faces),
        )


class FVMass:
    """Sparse FV (lumped) mass matrix on cells or faces."""

    def __init__(self, grid: Grid, mode: str = "cells", lumping: bool = True) -> None:
        if mode == "cells":
            self.mat = sps.diags(
                np.prod(grid.voxel_size) * np.ones(grid.num_cells, dtype=float)
            )
        elif mode == "faces":
            if not lumping:
                raise NotImplementedError("Only lumped face mass supported.")
            self.mat = sps.diags(
                np.prod(grid.voxel_size) * np.ones(grid.num_faces, dtype=float)
            )
        else:
            raise ValueError(f"Mode {mode} not supported.")


def _take(arr: torch.Tensor, start: int, stop: Optional[int], axis: int) -> torch.Tensor:
    slicer = [slice(None)] * arr.dim()
    slicer[axis] = slice(start, stop)
    return arr[tuple(slicer)]


def _face_to_cell_component(shape: tuple, face_array: torch.Tensor, axis: int):
    """Average axis-faces to cell centres (zero at the boundary closure)."""
    cell = face_array.new_zeros(shape)
    _take(cell, 0, -1, axis).add_(0.5 * face_array)
    _take(cell, 1, None, axis).add_(0.5 * face_array)
    return cell


def tangential_face_components(arrays: list, shape: tuple) -> list:
    """Per face axis ``d``, the tangential flux components on the d-faces
    (the other axes in order), from per-axis face arrays: each component
    averaged to the cells, then the two cells beside each d-face averaged."""
    dim = len(shape)
    out = []
    for d in range(dim):
        tangential = []
        for t in range(dim):
            if t == d:
                continue
            cell_t = _face_to_cell_component(shape, arrays[t], t)
            tangential.append(0.5 * (_take(cell_t, 0, -1, d) + _take(cell_t, 1, None, d)))
        out.append(tangential)
    return out


class FVTangentialFaceReconstruction:
    """Reconstruct tangential flux components on faces (averaging).

    For each face, the tangential components are averaged from the parallel
    faces of the two neighbouring cells (up to 4 in 2d, 8 in 3d).
    """

    def __init__(self, grid: Grid) -> None:
        self.grid = grid

    def __call__(self, flat_flux) -> list:
        arrays = self.grid.face_arrays(as_tensor(flat_flux))
        return tangential_face_components(arrays, self.grid.shape)


class FVFullFaceReconstruction:
    """Full vector-valued flux on faces (normal + tangential): a
    (num_faces, dim) tensor in the grid's face numbering."""

    def __init__(self, grid: Grid) -> None:
        self.grid = grid
        self.tangential = FVTangentialFaceReconstruction(grid)

    def __call__(self, flat_flux) -> torch.Tensor:
        grid = self.grid
        flat_flux = as_tensor(flat_flux)
        arrays = grid.face_arrays(flat_flux)
        tangential = tangential_face_components(arrays, grid.shape)
        blocks = []
        for d in range(grid.dim):
            components = list(tangential[d])
            components.insert(d, arrays[d])
            blocks.append(torch.stack([_fortran_ravel(c) for c in components], dim=-1))
        return torch.cat(blocks, dim=0)


def face_to_cell(grid: Grid, flat_flux, pt: Optional[np.ndarray] = None) -> torch.Tensor:
    """RT0 reconstruction of cell vector fluxes from face normal fluxes:
    a (*grid.shape, dim) tensor on the flux's device."""
    flat_flux = as_tensor(flat_flux)
    if pt is None:
        pt = np.ones(grid.dim) / 2
    pt = np.atleast_1d(pt)
    arrays = grid.face_arrays(flat_flux)
    components = []
    for d in range(grid.dim):
        cell = arrays[d].new_zeros(grid.shape)
        _take(cell, 0, -1, d).add_(float(pt[d]) * arrays[d])
        _take(cell, 1, None, d).add_(float(1 - pt[d]) * arrays[d])
        components.append(cell)
    return torch.stack(components, dim=-1)


def cell_to_face_average(grid: Grid, cell_qty, mode: str) -> torch.Tensor:
    """Average a cell quantity to faces (arithmetic or regularized harmonic):
    a flat (num_faces,) tensor on the quantity's device."""
    cell_qty = as_tensor(cell_qty)
    if cell_qty.dim() == grid.dim or (
        cell_qty.dim() == grid.dim + 1 and cell_qty.shape[-1] == 1
    ):
        components = [cell_qty.reshape(grid.shape)] * grid.dim
    elif cell_qty.dim() == grid.dim + 1 and cell_qty.shape[-1] == grid.dim:
        components = [cell_qty[..., d] for d in range(grid.dim)]
    elif cell_qty.dim() == grid.dim + 2 and tuple(cell_qty.shape[-2:]) == (
        grid.dim,
        grid.dim,
    ):
        components = [cell_qty[..., d, d] for d in range(grid.dim)]
    else:
        raise NotImplementedError("Dimension not supported.")

    faces = []
    for d in range(grid.dim):
        a = _take(components[d], 0, -1, d)
        b = _take(components[d], 1, None, d)
        if mode == "arithmetic":
            avg = 0.5 * (a + b)
        elif mode == "harmonic":
            denom = a + b
            safe = torch.where(denom == 0, torch.ones_like(denom), denom)
            avg = torch.where(denom > 0, 2.0 * a * b / safe, torch.zeros_like(denom))
        else:
            raise ValueError(f"Mode {mode} not supported.")
        faces.append(avg)
    return grid.flat_flux(faces)
