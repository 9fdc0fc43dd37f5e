"""Mass-data loading helpers for comparisons.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.mass` (reference
``presets/workflows/utils/mass.py``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ....experiment.experiment import ProtocolledExperiment
from ....image.imread import imread

__all__ = ["load_data"]


def load_data(config, data: str, time: float, tol: Optional[float] = None, device=None):
    """Load exported result data (currently 'mass') closest to a time [h].

    ``config`` is a run's config (its ``analysis.mass.folder``, ``data`` and
    ``protocol`` sections); the npz map closest in time (within ``tol``
    hours) is read onto ``device`` (the CUDA card when None), or None is
    returned when there is none.
    """
    if data != "mass":
        raise ValueError(f"Data type {data!r} not recognized.")
    folder = Path(config.analysis.mass.folder) / "mass" / "npz"
    if not folder.exists():
        folder = Path(config.analysis.mass.folder)
    available = sorted(folder / name for name in os.listdir(folder) if name.endswith(".npz"))
    if not available:
        return None
    experiment = ProtocolledExperiment.init_from_config(config)
    try:
        path = experiment.find_images_for_times(
            times=time,
            tol=tol * 3600 if tol is not None else None,
            data=available,
        )
    except ValueError:
        return None
    if path is None:
        return None
    return imread(path, device=device)
