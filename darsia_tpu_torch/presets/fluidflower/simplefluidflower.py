"""SimpleFluidFlower: lightweight rig with configurable correction chain.

Counterpart of :mod:`darsia_tpu.presets.fluidflower.simplefluidflower`, on
the port's checker finder, drift, curvature, illumination, dynamic
illumination and colour corrections, ``Resize``, ``random_patches``,
``segment`` and ``read_correction``.  The baseline and every photograph are
read onto ``device`` (the CUDA card when None); ``read_image`` corrects a
photograph with one ``imread(..., transformations=...)`` call, where the
drift and curvature corrections fuse into one warp (K1 on the card).

The type correction asks for float32 where the JAX package asks for
float64: the JAX package runs without 64-bit floats, so its
``TypeCorrection(np.float64)`` hands its drift and curvature warps float32
data, and the port's chain (K1 takes float32 only) is given the same.  A
failed colour-correction set-up is swallowed with a warning, as in the JAX
package.  ``setup_curvature_correction`` reads a marked ROI photograph
onto the device and finds its corners with the crop assistant.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Literal, Optional
from warnings import warn

import numpy as np
import torch

from ...corrections.base import TypeCorrection, read_correction
from ...corrections.color.colorcheckerfinder import find_colorchecker
from ...corrections.color.colorcorrection import ColorCorrection
from ...corrections.color.dynamicilluminationcorrection import (
    DynamicIlluminationCorrection,
)
from ...corrections.color.illuminationcorrection import IlluminationCorrection
from ...corrections.shape.curvature import CurvatureCorrection
from ...corrections.shape.drift import DriftCorrection
from ...image.image import as_numpy
from ...image.imread import imread
from ...restoration.resize import Resize, resize
from ...utils.box import random_patches
from ...utils.segmentation import segment

__all__ = ["SimpleFluidFlower"]

_DEFAULT_CORRECTIONS = ["type", "drift", "curvature", "relative-color", "color"]


class SimpleFluidFlower:
    """Simple rig assuming mild curvature and one dominating sand layer."""

    def __init__(
        self,
        baseline: Path,
        active_corrections: Optional[list] = None,
        extra_active_corrections: Optional[list] = None,
        debug: bool = False,
        device=None,
    ) -> None:
        self.device = device
        self.raw_baseline = imread(baseline, device=device)
        self.reference_date = self.raw_baseline.date
        self.corrections: list = []
        self.drift_config: dict = {}
        self.curvature_config: dict = {}
        self.debug = debug
        active = (
            _DEFAULT_CORRECTIONS if active_corrections is None else active_corrections
        )
        extra = extra_active_corrections or []
        self.active_type_correction = "type" in active
        self.active_resize_correction = "resize" in active
        self.active_drift_correction = "drift" in active
        self.active_curvature_correction = "curvature" in active
        self.active_relative_color_correction = "relative-color" in active
        self.active_illumination_correction = "illumination" in active
        self.active_dynamic_illumination_correction = (
            "dynamic-illumination" in active
        )
        self.active_color_correction = "color" in active
        self.extra_active_color_correction = "color" in extra

    # --------------------------------------------------------------- setup

    def setup(
        self,
        specs: dict,
        segmentation: Optional[Path] = None,
        curvature_options: Optional[dict] = None,
        relative_color_options: Optional[dict] = None,
        illumination_options: Optional[dict] = None,
        dynamic_illumination_options: Optional[dict] = None,
    ) -> None:
        """Build the correction chain from rig specs."""
        self.width = specs.get("width", 0.92)
        self.height = specs.get("height", 0.55)
        self.water_height = specs.get("water_height", 0.529)
        self.depth = specs.get("depth", 0.012)
        self.porosity = specs.get("porosity", 0.44)
        self.colorchecker_position = specs.get(
            "colorchecker_position", "upper_right"
        )

        self.corrections = []
        self.baseline = self.raw_baseline.copy()

        if self.active_type_correction:
            self.type_conversion = TypeCorrection(np.float32)
            self.corrections.append(self.type_conversion)
            self.baseline = self.type_conversion(self.baseline)

        if self.active_resize_correction:
            shape = tuple(self.baseline.img.shape[:2])
            self.resize_correction = Resize(shape=shape)
            self.corrections.append(self.resize_correction)

        if self.active_drift_correction:
            self.drift_correction = self.setup_drift_correction()
            self.corrections.append(self.drift_correction)
            self.baseline = self.drift_correction(self.baseline)

        if self.active_curvature_correction:
            options = curvature_options or {}
            if "cache" in options:
                self.curvature_correction = CurvatureCorrection()
                self.curvature_correction.load(
                    Path(options["cache"]) / "curvature.npz"
                )
            elif "config" in options:
                self.curvature_correction = CurvatureCorrection(
                    config=options["config"]
                )
            else:
                raise ValueError(
                    "curvature_options must provide 'cache' or 'config' "
                    "(interactive ROI selection is not available headless)."
                )
            self.corrections.append(self.curvature_correction)
            self.baseline = self.curvature_correction(self.baseline)

        if segmentation is not None:
            self.labels = self.setup_segmentation(segmentation)
        else:
            self.labels = None

        if self.active_illumination_correction:
            self.illumination_correction = self.setup_illumination_correction(
                **(illumination_options or {})
            )
            self.corrections.append(self.illumination_correction)
            self.baseline = self.illumination_correction(self.baseline)

        if self.active_dynamic_illumination_correction:
            self.dynamic_illumination_correction = (
                self.setup_dynamic_illumination_correction(
                    self.baseline, dynamic_illumination_options or {}
                )
            )
            self.corrections.append(self.dynamic_illumination_correction)

        if self.active_relative_color_correction:
            warn("relative-color correction requires explicit calibration; skipped.")

        if self.active_color_correction:
            try:
                self.color_correction = self.setup_color_correction()
                self.corrections.append(self.color_correction)
                self.baseline = self.color_correction(self.baseline)
            except Exception as e:
                warn(f"Color correction not set up: {e}")

    def setup_drift_correction(self) -> DriftCorrection:
        _, cc_voxels = find_colorchecker(
            self.raw_baseline, self.colorchecker_position
        )
        self.drift_config = {"roi": cc_voxels}
        return DriftCorrection(self.raw_baseline, config=self.drift_config)

    def setup_illumination_correction(
        self,
        illumination_mode: Literal["automatic"] = "automatic",
        width: int = 50,
        num_patches: int = 10,
        sigma: float = 200.0,
    ) -> IlluminationCorrection:
        from scipy import ndimage

        if self.labels is not None:
            labels_arr = as_numpy(self.labels.img)
            largest = np.argmax(np.bincount(labels_arr.ravel()))
            mask = labels_arr == largest
        else:
            mask = np.ones(tuple(self.baseline.img.shape[:2]), dtype=bool)
        samples = random_patches(mask.shape, width=width, num_patches=num_patches)
        illumination = IlluminationCorrection()
        illumination.setup(
            self.baseline,
            [samples],
            filter=lambda x: ndimage.gaussian_filter(x, sigma=sigma),
            colorspace="hsl-scalar",
            interpolation="illumination",
            show_plot=False,
        )
        return illumination

    def setup_dynamic_illumination_correction(
        self, baseline, options: dict
    ) -> DynamicIlluminationCorrection:
        correction = DynamicIlluminationCorrection()
        correction.setup(
            self.baseline if baseline is None else baseline, **options
        )
        return correction

    def setup_color_correction(self) -> ColorCorrection:
        colorchecker, cc_voxels = find_colorchecker(
            self.baseline, self.colorchecker_position
        )
        self.color_config = {
            "colorchecker": colorchecker,
            "roi": cc_voxels,
            "clip": False,
        }
        return ColorCorrection(config=self.color_config)

    def setup_segmentation(self, segmentation: Path):
        """Load + align a (colored) segmentation sketch with the baseline."""
        segmentation_image = resize(
            imread(segmentation, device=self.device),
            ref_image=self.raw_baseline,
            interpolation="inter_nearest",
        )
        if hasattr(self, "curvature_correction"):
            segmentation_image = self.curvature_correction(segmentation_image)
        data = segmentation_image.img
        if data.dim() == 3:
            return segment(data, markers_method="gradient_based", device=data.device)
        out = segmentation_image.copy()
        out.img = data.to(torch.int64)
        return out

    def setup_curvature_correction(
        self,
        roi: Path,
        roi_mode: Literal["interactive", "automatic"] = "automatic",
        roi_color: Optional[list] = None,
    ) -> CurvatureCorrection:
        """Curvature correction from a marked ROI photograph: the photograph
        is read onto the rig's device and resized to the baseline, and a
        :class:`~darsia_tpu_torch.assistants.CropAssistant` finds the frame's
        corners, by hand or from marks of ``roi_color`` ("automatic", on the
        device); the crop config builds the correction."""
        from ...assistants.crop_assistant import CropAssistant

        if roi_mode == "automatic" and roi_color is None:
            raise ValueError(
                "roi_mode='automatic' requires roi_color (the RGB color "
                "of the corner marks in the ROI image)."
            )
        roi_image = resize(imread(roi, device=self.device), ref_image=self.raw_baseline)
        crop_assistant = CropAssistant(roi_image, width=self.width, height=self.height)
        if roi_mode == "interactive":
            self.curvature_config = crop_assistant()
        elif roi_mode == "automatic":
            self.curvature_config = crop_assistant.from_image(color=roi_color)
        else:
            raise ValueError(f"Unknown roi_mode: {roi_mode}")
        self.curvature_correction = CurvatureCorrection(config=self.curvature_config)
        return self.curvature_correction

    def set_corrections(self) -> None:
        """Rebuild correction objects from their stored configs."""
        if self.drift_config:
            self.drift_correction = DriftCorrection(
                self.raw_baseline, config=self.drift_config
            )
        if self.curvature_config:
            self.curvature_correction = CurvatureCorrection(
                config=self.curvature_config
            )
        if getattr(self, "color_config", None):
            self.color_correction = ColorCorrection(config=self.color_config)

    def activate_corrections(
        self, corrections: list, extra_corrections: Optional[list] = None
    ) -> None:
        """Select the active correction chain by name and refresh the
        corrected baseline.
        Known names: type, resize, drift, curvature, relative-color,
        illumination, dynamic-illumination, color."""
        extra_corrections = extra_corrections or []
        self.corrections = []
        self.extra_corrections = []
        for name, attr in (
            ("type", "type_conversion"),
            ("resize", "resize_correction"),
            ("drift", "drift_correction"),
            ("curvature", "curvature_correction"),
            ("relative-color", "relative_color_correction"),
            ("illumination", "illumination_correction"),
            ("dynamic-illumination", "dynamic_illumination_correction"),
            ("color", "color_correction"),
        ):
            if name in corrections and hasattr(self, attr):
                self.corrections.append(getattr(self, attr))
        if "color" in extra_corrections and hasattr(self, "color_correction"):
            self.extra_corrections.append(self.color_correction)

        self.baseline = self.raw_baseline.copy()
        for correction in self.corrections:
            self.baseline = correction(self.baseline)
        self.expert_knowledge(self.baseline)

    def restrict_to_water_height(self, img):
        """Crop to the water column [0, water_height]."""
        from ...utils.point import make_coordinate

        return img.subregion(
            roi=make_coordinate([[0, 0], [self.width, self.water_height]])
        )

    # -------------------------------------------------------------- access

    def expert_knowledge(self, img) -> None:
        """Hook for rig-specific constraints (no-op by default)."""

    def read_image(self, path: Path):
        img = imread(path, transformations=self.corrections, device=self.device)
        if self.reference_date is not None and img.date is not None:
            img.reference_date = self.reference_date
        self.expert_knowledge(img)
        return img

    # ------------------------------------------------------------------- io

    def save(self, folder: Path) -> None:
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "specs.json").write_text(
            json.dumps(
                {
                    "width": self.width,
                    "height": self.height,
                    "water_height": self.water_height,
                    "depth": self.depth,
                    "porosity": self.porosity,
                    "colorchecker_position": self.colorchecker_position,
                }
            )
        )
        self.baseline.save(folder / "baseline.npz")
        for i, correction in enumerate(self.corrections):
            name = type(correction).__name__.lower()
            correction.save(folder / f"correction_{i}_{name}.npz")
        if self.labels is not None:
            self.labels.save(folder / "labels.npz")

    def load(self, folder: Path) -> None:
        folder = Path(folder)
        specs = json.loads((folder / "specs.json").read_text())
        for key, value in specs.items():
            setattr(self, key, value)
        self.baseline = imread(folder / "baseline.npz", device=self.device)
        self.corrections = [
            read_correction(file)
            for file in sorted(folder.glob("correction_*.npz"))
        ]
        if (folder / "labels.npz").exists():
            self.labels = imread(folder / "labels.npz", device=self.device)
        else:
            self.labels = None
