"""Facies setup: labels -> facies via the config's mapping, checked against
the facies properties.

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.setup_facies`; the
labels are read on ``device`` (None: the card) and the properties' CSV with
the ``csv`` module (an ``.xlsx`` table raises).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

from ....image.image import as_numpy
from ....image.imread import imread
from ....utils.segmentation import reassign_labels
from ..config.fluidflower_config import FluidFlowerConfig
from .illustrations import save_discrete_map_illustration

logger = logging.getLogger(__name__)

__all__ = ["setup_facies"]


def setup_facies(cls=None, path=None, show: bool = False, device=None):
    if path is None:
        path = cls  # allow setup_facies(path)
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("facies", "labeling")
    labels = imread(config.labeling.labels, device=device)
    mapping = dict(config.facies.label_to_facies_map)
    for label_id in np.unique(as_numpy(labels.img)):
        mapping.setdefault(int(label_id), int(label_id))
    facies = reassign_labels(labels, mapping)

    props_path = Path(config.facies.props)
    if props_path.suffix == ".xlsx":
        raise NotImplementedError(
            f"{props_path}: Excel facies properties need pandas and openpyxl; save the table as .csv"
        )
    with open(props_path, newline="") as f:
        facies_ids = {int(np.float64(row["id"])) for row in csv.DictReader(f)}
    for facies_id in np.unique(as_numpy(facies.img)):
        if int(facies_id) not in facies_ids:
            raise ValueError(f"Facies id {facies_id} not found in facies properties.")
    facies_path = Path(config.facies.path)
    facies_path.parent.mkdir(parents=True, exist_ok=True)
    facies.save(facies_path)
    save_discrete_map_illustration(facies.img, facies_path.with_suffix(".jpg"), title="Facies")
    return facies
