"""Cross-run Wasserstein distance comparison.

Counterpart of :mod:`darsia_tpu.presets.workflows.comparison.comparison_wasserstein`
(reference ``presets/workflows/comparison/comparison_wasserstein.py``): every
pair of runs at every report time, W1 between their mass maps.  The pairs of
one grid are solved together by :func:`darsia_tpu_torch.parallel.batched_wasserstein`
(one Newton loop for the batch, on the maps' device); the result files and
the assembled CSV are the JAX package's, written without pandas.
"""

from __future__ import annotations

import csv
import itertools
import json
import logging
import math
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ....image.image import as_numpy
from ....measure.wasserstein import wasserstein_distance
from ....parallel.wasserstein import batched_wasserstein
from ....restoration.resize import Resize
from ..utils.mass import load_data

logger = logging.getLogger(__name__)

__all__ = ["WassersteinDistanceResult", "comparison_wasserstein"]

@dataclass
class WassersteinDistanceResult:
    run_a: str
    run_b: str
    time: float
    distance: float
    roi: Optional[str] = None
    metadata: dict = field(default_factory=dict)

    @staticmethod
    def get_filename(run_1: str, run_2: str, time: float, roi_name: str) -> str:
        """Standardized intermediate-result filename."""
        roi = roi_name or "full"
        return (f"wasserstein_{run_1}_vs_{run_2}_t{time:07.3f}_{roi}.json").replace(" ", "_")

    def get_result_filename(self) -> str:
        return self.get_filename(self.run_a, self.run_b, self.time, self.roi)

    def save(self, path: Path) -> None:
        """Save this result as JSON at an explicit path."""
        Path(path).write_text(json.dumps(asdict(self), default=str, indent=2))

    def save_to_dir(self, directory: Path) -> Path:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / self.get_result_filename()
        self.save(path)
        return path

    @classmethod
    def load(cls, filename: Path) -> "WassersteinDistanceResult":
        data = json.loads(Path(filename).read_text())
        return cls(**data)


def _load_mass(run_name, config, time, tol, resize_factor, device=None):
    run_config = config.runs.config[run_name]
    mass = load_data(run_config, data="mass", time=time, tol=tol, device=device)
    if mass is None:
        logger.warning("Mass for run %s at t=%s not found.", run_name, time)
        return None
    if resize_factor is not None and resize_factor != 1.0:
        mass = Resize(fx=resize_factor, fy=resize_factor)(mass)
    return mass


def _compute(cls, config, skip_existing: bool, device=None) -> list:
    """Cross-run W1 sweep.

    All valid pairs are gathered first: pairs with a non-positive mass, or
    whose masses differ by more than ``relative_tol``, are skipped.  Then
    they are grouped by grid (shape and voxel size); each group of more than
    one pair takes one :func:`batched_wasserstein` call, the rest one
    ``wasserstein_distance(..., method="newton")`` each.  The maps are read
    onto ``device`` (the CUDA card when None) and solved there.
    """
    wconfig = config.wasserstein
    results = []
    jobs = []  # (result, mass_a, mass_b, metadata)
    for run_a, run_b in itertools.combinations(wconfig.runs, 2):
        for time, tol in wconfig.times:
            result = WassersteinDistanceResult(
                run_a=str(run_a), run_b=str(run_b), time=float(time), distance=float("nan")
            )
            out_path = Path(wconfig.results) / result.get_result_filename()
            if skip_existing and out_path.exists():
                continue
            mass_a = _load_mass(run_a, config, time, tol, wconfig.resize_factor, device)
            mass_b = _load_mass(run_b, config, time, tol, wconfig.resize_factor, device)
            if mass_a is None or mass_b is None:
                continue
            # The totals on the host in float64, summed as the JAX package
            # sums them, so both packages skip the same pairs.
            total_a = float(np.asarray(as_numpy(mass_a.img), dtype=float).sum())
            total_b = float(np.asarray(as_numpy(mass_b.img), dtype=float).sum())
            if min(total_a, total_b) <= 0:
                continue
            if (
                wconfig.relative_tol is not None
                and abs(total_a - total_b) / max(total_a, total_b) > wconfig.relative_tol
            ):
                logger.warning(
                    "Mass mismatch %s vs %s at t=%s too large; skipping.", run_a, run_b, time
                )
                continue
            jobs.append((result, mass_a, mass_b, {"total_a": total_a, "total_b": total_b}))

    # Group by (shape, voxel size): one batched solve per group.
    groups: dict = {}
    for job in jobs:
        _, mass_a, mass_b, _ = job
        key = (
            tuple(mass_a.num_voxels),
            tuple(np.round(np.asarray(mass_a.voxel_size, dtype=float), 12)),
        )
        if tuple(mass_b.num_voxels) != key[0]:
            key = None  # mismatched pair: solved alone
        groups.setdefault(key, []).append(job)

    for key, group in groups.items():
        if key is not None and len(group) > 1:
            shape, voxel_size = key
            solve = batched_wasserstein(shape, list(voxel_size))
            srcs = torch.stack([job[1].img.to(torch.float32) for job in group])
            dsts = torch.stack([job[2].img.to(torch.float32).to(srcs.device) for job in group])
            dists, _, _ = solve(srcs, dsts)
            distances = [float(d) for d in dists]
        else:
            distances = [
                float(wasserstein_distance(job[1], job[2], method="newton")) for job in group
            ]
        for job, distance in zip(group, distances):
            result, _, _, metadata = job
            result.distance = distance
            result.metadata = metadata
            result.save_to_dir(wconfig.results)
            results.append(result)
            logger.info(
                "W1(%s, %s; t=%s) = %.6g", result.run_a, result.run_b, result.time, result.distance
            )
    return results


def _csv_cell(value) -> str:
    """A cell as pandas' ``to_csv`` writes it: empty for None and NaN, the
    shortest repr for a float, ``str`` otherwise."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _assemble(config) -> list:
    """Read every ``wasserstein_*.json`` result (sorted by name) and write
    them as ``wasserstein_distances.csv`` beside them (the JAX package's
    file: same header, order and cells); returns the rows as dicts."""
    wconfig = config.wasserstein
    rows = [
        asdict(WassersteinDistanceResult.load(file))
        for file in sorted(Path(wconfig.results).glob("wasserstein_*.json"))
    ]
    out = Path(wconfig.results) / "wasserstein_distances.csv"
    with open(out, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(rows[0]) if rows else [])
        for row in rows:
            writer.writerow([_csv_cell(v) for v in row.values()])
    logger.info("Assembled %d results into %s.", len(rows), out)
    return rows


def comparison_wasserstein(
    cls,
    path,
    compute: bool = False,
    assemble: bool = False,
    skip_existing: bool = False,
    device=None,
):
    """Compute or assemble cross-run Wasserstein distances from a
    ``MultiFluidFlowerConfig`` file; the compute step solves on ``device``
    (None: the card)."""
    from ..config.multi_fluidflower_config import MultiFluidFlowerConfig

    assert compute + assemble == 1, "Exactly one of compute/assemble must be True."
    config = MultiFluidFlowerConfig(path, require_data=False, require_results=True)
    assert config.wasserstein is not None
    if compute:
        return _compute(cls, config, skip_existing, device=device)
    return _assemble(config)
