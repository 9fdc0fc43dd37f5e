"""FluidFlower benchmark CO2 analysis preset.

Counterpart of :mod:`darsia_tpu.presets.fluidflower.fluidflowerco2analysis`.
The expert-knowledge masks stay on the image's device: a map is masked with
one ``torch.where``, and whether any pixel is masked (so that the binary
clean-up runs again) is one host read.  Unlike the JAX package, the mask is
applied again after that clean-up, so CO2(g) stays inside CO2.  The contour
plots import matplotlib when asked for (``write_contours_to_file``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from ...manager.co2analysis import CO2Analysis
from ...utils.optional import agg_pyplot
from .benchmarkco2model import (
    benchmark_binary_cleaning_preset,
    benchmark_concentration_analysis_preset,
)

__all__ = ["FluidFlowerCO2Analysis"]


class FluidFlowerCO2Analysis(CO2Analysis):
    """Segment dissolved CO2 and CO2(g) in the photographs of a FluidFlower
    run.

    A subclass may set ``self.labels`` (a label map of the baseline's shape)
    before calling ``super().__init__`` to threshold per label; by default
    the whole image is one label.
    """

    def __init__(
        self,
        baseline,
        config: Union[str, Path],
        results: Union[str, Path],
        update_setup: bool = False,
        verbosity: int = 0,
        device=None,
    ) -> None:
        super().__init__(baseline, config, update_setup, device)
        if not hasattr(self, "labels"):
            self.labels = self._single_label()
        self.path_to_results = Path(results)
        self.path_to_results.parent.mkdir(parents=True, exist_ok=True)
        self.verbosity = verbosity

    def _single_label(self) -> np.ndarray:
        return np.ones(tuple(self.base.img.shape[:2]), dtype=int)

    # ------------------------------------------------------------ detectors

    def define_co2_analysis(self):
        if not hasattr(self, "labels"):
            self.labels = self._single_label()
        self.co2_binary_cleaning = benchmark_binary_cleaning_preset(self.base, self.config["co2"])
        return benchmark_concentration_analysis_preset(self.base, self.labels, self.config["co2"])

    def define_co2_gas_analysis(self):
        self.co2_gas_binary_cleaning = benchmark_binary_cleaning_preset(
            self.base, self.config["co2(g)"]
        )
        return benchmark_concentration_analysis_preset(
            self.base, self.labels, self.config["co2(g)"]
        )

    # ---------------------------------------------------- expert knowledge

    def _expert_knowledge_co2(self):
        return torch.ones(tuple(self.base.img.shape[:2]), dtype=torch.bool, device=self.base.device)

    def _expert_knowledge_co2_gas(self, co2):
        return co2.img.to(torch.bool)

    # ------------------------------------------------------------- masking

    def _masked(self, detected, expert_knowledge, cleaning):
        """The map zeroed outside the expert knowledge (a numpy array or a
        tensor), cleaned again when any pixel was zeroed.

        The clean-up (holes filled, smoothed and thresholded again) can grow
        the mask past the expert knowledge; the JAX package keeps such
        pixels (ROADMAP, reference fault 22), so CO2(g) can leak out of CO2.
        Here the expert knowledge is applied once more after it."""
        inside = as_tensor(expert_knowledge, detected.device).to(torch.bool)
        zero = torch.zeros((), dtype=detected.img.dtype, device=detected.device)
        arr = torch.where(inside, detected.img, zero)
        if not bool(inside.all()):
            cleaned = as_tensor(cleaning(arr), detected.device)
            arr = torch.where(inside, cleaned, torch.zeros((), dtype=cleaned.dtype, device=detected.device))
        detected.img = arr
        return detected

    def determine_co2_mask(self):
        expert_knowledge = self._expert_knowledge_co2()
        self.co2_analysis.update(mask=expert_knowledge)
        return self._masked(self.determine_co2(), expert_knowledge, self.co2_binary_cleaning)

    def determine_co2_gas_mask(self, co2):
        expert_knowledge = self._expert_knowledge_co2_gas(co2)
        self.co2_gas_analysis.update(mask=expert_knowledge)
        return self._masked(self.determine_co2_gas(), expert_knowledge, self.co2_gas_binary_cleaning)

    # ------------------------------------------------------------ workflow

    def single_image_analysis(self, img, **kwargs):
        """Detect the CO2 phases in one photograph (a path, or an Image read
        already); optionally write the segmentation (water 0, dissolved 1,
        gas 2) as an int ``.npy``."""
        if hasattr(img, "img"):
            self.img = img.copy()
            img_id = Path(getattr(img, "name", "image") or "image").stem
        else:
            self.load_and_process_image(img)
            img_id = Path(img).stem
        co2 = self.determine_co2_mask()
        co2_gas = self.determine_co2_gas_mask(co2)

        if kwargs.pop("write_contours_to_file", False):
            plt = agg_pyplot("write_contours_to_file")

            out = self.path_to_results / "contour_plots"
            out.mkdir(parents=True, exist_ok=True)
            fig, ax = plt.subplots()
            ax.imshow(as_numpy(self.img.img.clamp(0, 1)))
            ax.contour(as_numpy(co2.img), levels=[0.5], colors="g")
            ax.contour(as_numpy(co2_gas.img), levels=[0.5], colors="y")
            fig.savefig(out / f"{img_id}_with_contours.jpg", dpi=200)
            plt.close(fig)

        if kwargs.pop("write_segmentation_to_file", False) or kwargs.pop(
            "write_coarse_segmentation_to_file", False
        ):
            c, g = co2.img.to(torch.bool), co2_gas.img.to(torch.bool)
            segmentation = torch.where(g, 2, c.to(torch.int64))
            out = self.path_to_results / "npy_segmentation"
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / f"{img_id}_segmentation.npy", as_numpy(segmentation).astype(int))

        return co2, co2_gas
