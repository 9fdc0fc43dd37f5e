"""CO2 phase segmentation on a FluidFlower rig with named layers.

The port of the JAX package's ``examples/phase_segmentation.py`` (after the
reference's BASELINE validation config): a rig subclass tags water, ESF and
C-sand layers from the watershed segmentation of the baseline, CO2(g) is
excluded from the ESF layer by expert knowledge, and the standardized batch
analysis runs over the three CO2 frames.  The layer masks are boolean
tensors on the baseline's device.  Where matplotlib does not import, the
batch's contour plots raise naming it and the batch logs that and goes on,
as in the JAX package.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import FluidFlowerCO2Analysis, segment
from ..image.image import as_numpy, as_tensor, card_unless
from . import Report, cli
from .co2_analysis import phase_sections, save_frames


class LargeRigCO2Analysis(FluidFlowerCO2Analysis):
    """CO2 analysis on a rig with named geological layers and the ESF
    expert knowledge; the layer segmentation runs after the set-up."""

    def __init__(self, baseline, config, results, update_setup=False, device=None):
        super().__init__(baseline, config, results, update_setup, device=device)
        self._segment_geometry(update_setup=update_setup)

    def _segment_geometry(self, update_setup: bool = False) -> None:
        seg = self.config["segmentation"]
        labels_path = Path(seg["labels_path"])
        if labels_path.exists() and not update_setup:
            self.labels = as_tensor(np.load(labels_path), self.base.device)
        else:
            labels = segment(
                self.base,
                markers_method="supervised",
                edges_method="scharr",
                marker_points=seg["marker_points"],
                device=self.base.device,
            )
            self.labels = labels.img
            labels_path.parent.mkdir(parents=True, exist_ok=True)
            np.save(labels_path, as_numpy(self.labels))
        self.water = self._labels_to_mask(seg.get("water", []))
        self.esf_sand = self._labels_to_mask(seg.get("esf", []))
        self.c_sand = self._labels_to_mask(seg.get("c", []))

    def _labels_to_mask(self, ids) -> torch.Tensor:
        ids = ids if isinstance(ids, list) else [ids]
        return torch.isin(self.labels, torch.tensor(ids, dtype=self.labels.dtype, device=self.labels.device))

    def _expert_knowledge_co2_gas(self, co2) -> torch.Tensor:
        return co2.img.to(torch.bool) & ~self.esf_sand


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the phase segmentation example")
    report = Report()
    work = Path(tempfile.mkdtemp(prefix="phase_segmentation_"))
    paths = save_frames(work, device)
    config = {
        "physical_asset": {"dimensions": {"width": 2.8, "height": 1.5}},
        "segmentation": {
            "labels_path": str(work / "cache" / "labels.npy"),
            "marker_points": [[45, 170], [135, 170]],
            "water": [1],
            "esf": [1],
            "c": [2],
        },
        **phase_sections(work),
    }
    config_path = work / "config.json"
    config_path.write_text(json.dumps(config))

    analysis = LargeRigCO2Analysis(
        baseline=work / "baseline.npz", config=config_path, results=work / "results", device=device
    )
    water, esf = float(analysis.water.double().mean()), float(analysis.esf_sand.double().mean())
    report("layers: water", water, "esf", esf)

    # Standardized CO2 batch analysis with contours written to file.
    analysis.batch_analysis(paths, plot_contours=False, write_contours_to_file=True)
    fractions = []
    for i, path in enumerate(paths):
        co2, co2_gas = analysis.single_image_analysis(path)
        c, g = co2.img.to(torch.bool), co2_gas.img.to(torch.bool)
        in_esf = int((g & analysis.esf_sand).sum())
        share_c, share_g = float(c.double().mean()), float(g.double().mean())
        fractions.append((share_c, share_g))
        report(f"co2_{i}: co2 {share_c:.3f}, gas {share_g:.3f}, gas in esf: {in_esf}")
        if in_esf != 0:
            raise RuntimeError("expert knowledge must exclude CO2(g) from ESF")
    report("results in", work / "results")
    return {"lines": report.lines, "layers": (water, esf), "fractions": fractions}


if __name__ == "__main__":
    cli(main)
