"""Facies properties (porosity and permeability per facies label).

Counterpart of :mod:`darsia_tpu.presets.workflows.facies_props`.  The maps
are float32 on the facies' device, one gather of a per-label table
(labels without a value get 0, as in the JAX package); the CSV is read with
the ``csv`` module, where the JAX package uses pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Union

import numpy as np

from ...multiphase.mass_analysis import full_like
from ...signals.models.basemodel import LabelIndex

__all__ = ["FaciesProps"]


class FaciesProps:
    """Per-facies porosity and permeability maps."""

    def __init__(
        self,
        facies,
        porosity: Union[float, dict] = 1.0,
        permeability: Union[float, dict] = 1.0,
    ) -> None:
        self.facies = facies
        index = LabelIndex(facies.img)
        device = facies.img.device

        def _expand(values):
            if isinstance(values, dict):
                table = {int(label): float(value) for label, value in values.items()}
                per_label = [table.get(int(label), 0.0) for label in index.unique]
            else:
                per_label = [float(values)] * len(index)
            return full_like(facies, index.gather(per_label, device))

        self.porosity = _expand(porosity)
        self.permeability = _expand(permeability)

    @classmethod
    def load(cls, facies, path: Path) -> "FaciesProps":
        """Load facies properties from a CSV with columns id, porosity,
        permeability (an ``.xlsx`` file raises: no Excel reader on the
        card's machine)."""
        path = Path(path)
        if path.suffix.lower() == ".xlsx":
            raise NotImplementedError(
                f"{path}: Excel facies properties need pandas and openpyxl; save the table as .csv"
            )
        if path.suffix.lower() != ".csv":
            raise ValueError("Facies properties file must be .csv or .xlsx.")
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        required = {"id", "porosity", "permeability"}
        columns = set(rows[0].keys()) if rows else set()
        if not required.issubset(columns):
            raise ValueError(f"Facies properties file must contain columns {sorted(required)}.")
        ids = [int(np.float64(row["id"])) for row in rows]
        porosity = dict(zip(ids, (float(row["porosity"]) for row in rows)))
        permeability = dict(zip(ids, (float(row["permeability"]) for row in rows)))
        return cls(facies, porosity=porosity, permeability=permeability)
