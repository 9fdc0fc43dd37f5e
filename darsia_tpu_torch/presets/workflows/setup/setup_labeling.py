"""Labeling setup: segment a manually coloured sketch into labels.

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.setup_labeling`; the
sketch is read on ``device`` (None: the card), labelled on the host and
saved as ``.npz``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ....image.image import as_numpy
from ....image.imread import imread
from ....utils.segmentation import group_labels, label_image, make_consecutive
from ..config.fluidflower_config import FluidFlowerConfig
from .illustrations import save_discrete_map_illustration

logger = logging.getLogger(__name__)

__all__ = ["segment_colored_image"]


def segment_colored_image(path, show: bool = False, device=None):
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("labeling", "rig")
    colored = imread(
        config.labeling.colored_image,
        width=config.rig.width,
        height=config.rig.height,
        device=device,
    )
    labels = label_image(colored, significance=config.labeling.rtol)
    logger.info("Num unique labels: %d", len(np.unique(as_numpy(labels.img))))
    if config.labeling.unite_labels:
        groups = [tuple(group) for group in config.labeling.unite_labels]
        labels = make_consecutive(group_labels(labels, groups))
    labels_path = Path(config.labeling.labels)
    labels_path.parent.mkdir(parents=True, exist_ok=True)
    labels.save(labels_path)
    save_discrete_map_illustration(labels.img, labels_path.with_suffix(".jpg"), title="Labels")
    return labels
