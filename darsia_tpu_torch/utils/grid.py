"""Tensor grids: cell and face numbering for finite-volume discretizations.

Counterpart of :mod:`darsia_tpu.utils.grid`.  The index tables are numpy, as
there, with the same column-major (Fortran-order) numbering, so flat face
vectors are interchangeable between the packages.  The Beckmann solvers
never build matrices over these indices; they work on per-axis face arrays
(``face_arrays``/``flat_flux``, which take tensors as well as numpy arrays).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["Grid", "generate_grid"]


def _fortran_view(flat: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``flat`` reshaped to ``shape`` in Fortran order (numpy's order="F")."""
    n = len(shape)
    return flat.reshape(tuple(reversed(shape))).permute(*reversed(range(n)))


def _fortran_ravel(array: torch.Tensor) -> torch.Tensor:
    """``np.ravel(array, "F")`` for a tensor."""
    return array.permute(*reversed(range(array.dim()))).reshape(-1)


class Grid:
    """Tensor grid with interior-face numbering (boundary fluxes excluded)."""

    def __init__(self, shape: tuple, voxel_size: Union[float, list] = 1.0) -> None:
        self.dim = len(shape)
        self.shape = tuple(int(s) for s in shape)
        self.voxel_size = (
            np.array(voxel_size, dtype=float)
            if isinstance(voxel_size, (list, tuple, np.ndarray))
            else float(voxel_size) * np.ones(self.dim)
        )
        assert len(self.voxel_size) == self.dim
        self.face_vol = [
            float(np.prod(np.delete(self.voxel_size, d))) for d in range(self.dim)
        ]
        self.cell_vol = float(np.prod(self.voxel_size))
        self._setup()

    def _setup(self) -> None:
        self.num_cells = int(np.prod(self.shape))
        self.cell_index = np.arange(self.num_cells, dtype=int).reshape(
            self.shape, order="F"
        )

        self.faces_shape = [
            tuple(int(s) for s in np.array(self.shape) - np.eye(self.dim, dtype=int)[d])
            for d in range(self.dim)
        ]
        self.num_faces_per_axis = [int(np.prod(s)) for s in self.faces_shape]
        self.num_faces = int(np.sum(self.num_faces_per_axis))

        self.faces = [
            sum(self.num_faces_per_axis[:d])
            + np.arange(self.num_faces_per_axis[d], dtype=int)
            for d in range(self.dim)
        ]
        self.face_index = [
            self.faces[d].reshape(self.faces_shape[d], order="F")
            for d in range(self.dim)
        ]

        # Interior faces (not touching the domain boundary tangentially).
        sl = slice(1, -1)
        full = slice(None)
        self.interior_faces = []
        for d in range(self.dim):
            slices = tuple(full if ax == d else sl for ax in range(self.dim))
            self.interior_faces.append(np.ravel(self.face_index[d][slices], "F"))
        self.exterior_faces = [
            np.sort(
                np.array(
                    list(set(self.faces[d]) - set(self.interior_faces[d])), dtype=int
                )
            )
            for d in range(self.dim)
        ]

        # Connectivity face -> (cell before, cell after) along its axis.
        self.connectivity = np.zeros((self.num_faces, 2), dtype=int)
        for d in range(self.dim):
            before = tuple(slice(0, -1) if ax == d else full for ax in range(self.dim))
            after = tuple(slice(1, None) if ax == d else full for ax in range(self.dim))
            self.connectivity[self.faces[d], 0] = np.ravel(self.cell_index[before], "F")
            self.connectivity[self.faces[d], 1] = np.ravel(self.cell_index[after], "F")

        # Reverse connectivity cell -> (face before, face after) per axis.
        self.reverse_connectivity = -np.ones((self.dim, self.num_cells, 2), dtype=int)
        for d in range(self.dim):
            before = tuple(slice(1, None) if ax == d else full for ax in range(self.dim))
            after = tuple(slice(0, -1) if ax == d else full for ax in range(self.dim))
            self.reverse_connectivity[d, np.ravel(self.cell_index[before], "F"), 0] = (
                self.faces[d]
            )
            self.reverse_connectivity[d, np.ravel(self.cell_index[after], "F"), 1] = (
                self.faces[d]
            )

    # ------------------------------------------------- face-array interface

    def face_arrays(self, flat_flux) -> list:
        """Split a flat face vector (numpy or tensor) into per-axis face
        arrays of the same kind (a tensor's stay on its device)."""
        if isinstance(flat_flux, torch.Tensor):
            out, offset = [], 0
            for d in range(self.dim):
                n = self.num_faces_per_axis[d]
                out.append(
                    _fortran_view(flat_flux[offset : offset + n], self.faces_shape[d])
                )
                offset += n
            return out
        return [
            np.asarray(flat_flux)[self.faces[d]].reshape(self.faces_shape[d], order="F")
            for d in range(self.dim)
        ]

    def flat_flux(self, face_arrays: list):
        """Concatenate per-axis face arrays (numpy or tensors) into a flat
        face vector."""
        if isinstance(face_arrays[0], torch.Tensor):
            return torch.cat([_fortran_ravel(face_arrays[d]) for d in range(self.dim)])
        return np.concatenate(
            [np.ravel(np.asarray(face_arrays[d]), "F") for d in range(self.dim)]
        )


def generate_grid(image) -> Grid:
    """Grid matching an image's voxel layout."""
    return Grid(tuple(image.num_voxels), list(image.voxel_size))
