"""JSON-config-driven analysis managers.

Counterpart of :mod:`darsia_tpu.manager.analysisbase`.  Every photograph is
read through :func:`~darsia_tpu_torch.image.imread.imread` with the assembled
correction chain onto ``device`` (the CUDA card unless the caller names
another), where runs of adjacent geometric corrections fuse into one K1 pair.
In the chain's order (drift, deformation, colour, translation, curvature)
the colour correction splits a drift from a curvature correction: with the
three configured a read makes two geometric runs (a K1 pair each) and the
colour correction's checker crop (one more pair).
"""

from __future__ import annotations

import json
import logging
import time
from datetime import datetime
from pathlib import Path
from typing import Optional, Union

from ..corrections.color.colorcorrection import ColorCorrection
from ..corrections.shape.curvature import CurvatureCorrection
from ..corrections.shape.deformation import DeformationCorrection
from ..corrections.shape.drift import DriftCorrection
from ..corrections.shape.translation import TranslationCorrection
from ..image.imread import imread

logger = logging.getLogger(__name__)

__all__ = ["AnalysisBase"]

#: The correction chain in the order it is applied: (attribute, config
#: section, kind).  Corrections anchored at the baseline (drift, deformation)
#: are built against the baseline read through the corrections built before
#: them, so the chain is assembled stage by stage.
_PIPELINE = (
    ("drift_correction", "drift", "baseline"),
    ("deformation_correction", "deformation", "baseline"),
    ("color_correction", "color", "plain"),
    ("translation_correction", "translation", "translation"),
    ("curvature_correction", "curvature", "plain"),
)


class AnalysisBase:
    """Standard time-series analysis set up from a JSON config.

    Args:
        baseline: path of the baseline (or a list of paths; the first one
            anchors the corrections).
        config: path of the JSON config (``physical_asset.dimensions`` and
            one section per correction).
        update_setup: recompute cached set-up data.
        device: where images are read to (default: the CUDA card).

    """

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        update_setup: bool = False,
        device=None,
    ) -> None:
        self.config = json.loads(Path(config).read_text())
        self.device = device

        dims = self.config.get("physical_asset", {}).get("dimensions")
        if dims is None:
            raise ValueError("Config lacks physical_asset.dimensions (width/height).")
        self.width = dims["width"]
        self.height = dims["height"]
        self.origin = [0.0, self.height]

        stamp = self.config.get("reference_date")
        self.reference_date: Optional[datetime] = (
            datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S") if stamp else None
        )

        anchor = baseline[0] if isinstance(baseline, list) else baseline
        self.processed_baseline_images = None
        self.verbosity = self.config.get("verbosity", False)

        for attribute, _section, _kind in _PIPELINE:
            setattr(self, attribute, None)

        self.uncorrected_base = self._read(anchor)
        for attribute, section, kind in _PIPELINE:
            if section not in self.config:
                continue
            section_config = self.config[section]
            if kind == "baseline":
                correction = {
                    "drift": DriftCorrection,
                    "deformation": DeformationCorrection,
                }[section](base=self._read(anchor), config=section_config)
            elif kind == "translation":
                correction = TranslationCorrection(translation=section_config)
            else:
                factory = {"color": ColorCorrection, "curvature": CurvatureCorrection}[section]
                correction = factory(config=section_config)
            setattr(self, attribute, correction)
            if section == "drift":
                # The drift-aligned baseline, for subclasses that re-anchor on it.
                self.drift_corrected_base = self._read(anchor)
        if not hasattr(self, "drift_corrected_base"):
            self.drift_corrected_base = self.uncorrected_base

        self.base = self._read(anchor)

    def _read(self, path):
        """Read one image through the chain assembled so far."""
        chain = [getattr(self, attribute) for attribute, _s, _k in _PIPELINE]
        return imread(
            path,
            transformations=chain,
            width=self.width,
            height=self.height,
            origin=self.origin,
            reference_date=self.reference_date,
            device=self.device,
        )

    def load_and_process_image(self, path):
        self.img = self._read(path)
        return self.img

    def single_image_analysis(self, img, **kwargs):
        raise NotImplementedError("Subclasses define the per-image analysis.")

    def batch_analysis(self, images, **kwargs) -> None:
        """``single_image_analysis`` of each path; a failure is logged and
        the batch goes on."""
        batch = images if isinstance(images, list) else [images]
        for item in batch:
            tic = time.time()
            try:
                self.single_image_analysis(item, **kwargs)
            except Exception as exc:
                logger.error("Analysis of %s failed: %s", item, exc)
                continue
            if self.verbosity:
                logger.info("Analyzed %s in %.2f s", Path(item).name, time.time() - tic)
