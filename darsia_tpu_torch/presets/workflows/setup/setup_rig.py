"""Rig setup workflow step: build + persist the rig from a TOML config.

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.setup_rig`; the rig
is set up on ``device`` (None: the card).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

from ....experiment.experiment import ProtocolledExperiment
from ..config.fluidflower_config import FluidFlowerConfig
from ..rig import Rig

logger = logging.getLogger(__name__)

__all__ = ["setup_rig", "delete_rig"]


def setup_rig(cls=Rig, path=None, show: bool = False, device=None) -> Rig:
    """Build the rig from config (corrections, depth, labels, facies,
    porosity) and save it to config.rig.path."""
    if path is None:
        path, cls = cls, Rig  # allow setup_rig(path)
    config = FluidFlowerConfig(path, require_data=True, require_results=False)
    config.check("data", "rig", "depth", "labeling", "protocol")
    experiment = ProtocolledExperiment.init_from_config(config)

    facies_npz = Path(config.facies.path).with_suffix(".npz") if config.facies is not None else None
    rig = cls()
    rig.setup(
        experiment=experiment,
        baseline_path=config.data.baseline,
        depth_map_path=Path(config.depth.depth_map).with_suffix(".npz"),
        labels_path=Path(config.labeling.labels).with_suffix(".npz"),
        facies_path=facies_npz if facies_npz is not None and facies_npz.exists() else None,
        facies_props_path=config.facies.props if config.facies is not None else None,
        corrections_config=config.corrections,
        image_porosity_config=config.image_porosity,
        show_plot=show,
        device=device,
    )
    rig.save(config.rig.path)
    logger.info("Rig saved to %s.", config.rig.path)
    return rig


def delete_rig(path) -> bool:
    """Remove a previously saved rig folder."""
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("rig")
    folder = Path(config.rig.path)
    if folder.exists():
        shutil.rmtree(folder)
        logger.info("Rig folder %s removed.", folder)
        return True
    return False
