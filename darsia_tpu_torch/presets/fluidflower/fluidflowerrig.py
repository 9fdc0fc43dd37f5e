"""FluidFlower rig manager with a watershed segmentation of its geometry.

Counterpart of :mod:`darsia_tpu.presets.fluidflower.fluidflowerrig`: the
labels are segmented once (:func:`~darsia_tpu_torch.utils.segmentation.segment`)
and cached as the same ``.npy`` file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ...image.image import as_numpy
from ...manager.analysisbase import AnalysisBase
from ...utils.segmentation import segment

__all__ = ["FluidFlowerRig"]


class FluidFlowerRig(AnalysisBase):
    """AnalysisBase + the watershed segmentation of the rig's geometry
    (host numpy labels)."""

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        update_setup: bool = False,
        device=None,
    ) -> None:
        super().__init__(baseline, config, update_setup, device)
        self._segment_geometry(update_setup=update_setup)

    def _segment_geometry(self, update_setup: bool = False) -> None:
        """Segment the baseline, or read the labels cached at labels_path."""
        labels_path = Path(self.config["segmentation"]["labels_path"])
        if labels_path.exists() and not update_setup:
            labels = np.load(labels_path)
        else:
            labels = segment(
                as_numpy(self.base.img),
                markers_method="supervised",
                edges_method="scharr",
                device=self.base.device,
                **self.config["segmentation"],
            )
            labels_path.parent.mkdir(parents=True, exist_ok=True)
            np.save(labels_path, labels)
        self.labels = labels

    def _labels_to_mask(self, ids) -> np.ndarray:
        ids = ids if isinstance(ids, list) else [ids]
        return np.isin(self.labels, ids)
