"""Facies properties (porosity and permeability per facies label).

Counterpart of :mod:`darsia_tpu.presets.workflows.facies_props`.  The maps
are float32 on the facies' device, one gather of a per-label table
(labels without a value get 0, as in the JAX package); the CSV is read with
the ``csv`` module, where the JAX package uses pandas, and an ``.xlsx``
table through pandas (imported when called).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Union

import numpy as np

from ...multiphase.mass_analysis import full_like
from ...signals.models.basemodel import LabelIndex
from ...utils.csv_table import read_excel_columns

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
        """Load facies properties from a CSV or XLSX table with columns id,
        porosity, permeability."""
        path = Path(path)
        if path.suffix.lower() == ".xlsx":
            table = read_excel_columns(path, what="reading Excel facies properties")
        elif path.suffix.lower() == ".csv":
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            table = {name: [row[name] for row in rows] for name in (rows[0] if rows else {})}
        else:
            raise ValueError("Facies properties file must be .csv or .xlsx.")
        required = {"id", "porosity", "permeability"}
        if not required.issubset(table):
            raise ValueError(f"Facies properties file must contain columns {sorted(required)}.")
        ids = [int(np.float64(v)) for v in table["id"]]
        porosity = dict(zip(ids, (float(v) for v in table["porosity"])))
        permeability = dict(zip(ids, (float(v) for v in table["permeability"])))
        return cls(facies, porosity=porosity, permeability=permeability)
