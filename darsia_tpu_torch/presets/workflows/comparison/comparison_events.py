"""Cross-run event comparison: earliest times mass thresholds are reached.

Counterpart of :mod:`darsia_tpu.presets.workflows.comparison.comparison_events`.
The mass tables are read and the events table written with the ``csv``
module, where the JAX package uses pandas; the events file is the JAX
package's, byte for byte (empty cells for events never reached).
"""

from __future__ import annotations

import csv
import logging
import math
from pathlib import Path

import numpy as np

from .comparison_wasserstein import _csv_cell

logger = logging.getLogger(__name__)

__all__ = ["comparison_events"]

_MODE_TO_COLUMN = {
    "mass": "detected_mass",
    "mass_g": "detected_mass_g",
    "mass_aq": "detected_mass_aq",
}


def _read_table(path: Path) -> dict:
    """A CSV file as its columns: name -> list of cells (strings)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: [row[i] for row in rows] for i, name in enumerate(header)}


def _floats(cells: list) -> np.ndarray:
    return np.array([float(c) if c != "" else np.nan for c in cells], dtype=float)


def comparison_events(path) -> list:
    """For each run + event: earliest time the ROI mass exceeds the
    relative threshold of the total injected mass; write the events CSV.
    Returns the rows as dicts (column -> value)."""
    from ..config.multi_fluidflower_config import MultiFluidFlowerConfig

    config = MultiFluidFlowerConfig(path, require_results=True)
    assert config.events is not None and config.runs is not None
    columns = ["run"] + list(config.events.events.keys())
    rows = []
    for run, run_config in config.runs.config.items():
        assert run_config.data is not None
        row = dict.fromkeys(columns, math.nan)
        row["run"] = run
        mass = _read_table(Path(run_config.analysis.mass.folder) / "mass_analysis_results.csv")
        for event in config.events.events.values():
            if event.mode not in _MODE_TO_COLUMN:
                raise NotImplementedError(f"Event type {event.mode} not implemented.")
            key = f"{event.roi_name}_{_MODE_TO_COLUMN[event.mode]}"
            assert key in mass, f"Key {key} not in mass results."
            exact_cols = [c for c in mass if "exact_mass" in c]
            total_mass = float(np.max(_floats(mass[exact_cols[0]]))) if exact_cols else 1.0
            times = _floats(mass["time"])
            reached = times[_floats(mass[key]) >= event.relative_threshold * total_mass]
            row[event.event_id] = float(np.min(reached)) if len(reached) else math.nan
        rows.append(row)
    out = Path(config.events.path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_cell(row[c]) for c in columns])
    logger.info("Events written to %s.", out)
    return rows
