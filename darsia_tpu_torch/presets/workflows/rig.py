"""The Rig: central application object wiring corrections, geometry,
labels, porosity and mass analysis for a FluidFlower run.

Counterpart of :mod:`darsia_tpu.presets.workflows.rig`.  A rig lives on one
device (``Rig.setup(..., device=None)`` and ``Rig.load(folder,
device=None)``: the card unless the caller passes ``device="cpu"``): every
image it reads and every field it sets up is there.  ``read_image`` reads
through the port's ``imread(..., transformations=self.corrections)``, so
[Resize, drift, curvature] fuse into one pair of K1 launches, and the colour
checker's crop in ``ColorCorrection`` is a second pair.  The label
boundaries, the illumination samples and the averaging mask are computed on
the host, as in the JAX package; its folder is read and written both ways.
``read_images`` (the prefetching reader) is not ported yet.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional
from warnings import warn

import numpy as np
import torch

from ...corrections.base import TypeCorrection, read_correction
from ...corrections.color.colorcheckerfinder import find_colorchecker
from ...corrections.color.colorcorrection import ColorCorrection
from ...corrections.color.illuminationcorrection import IlluminationCorrection
from ...corrections.color.patchwiseilluminationcorrection import PatchwiseIlluminationCorrection
from ...corrections.color.relativecolorcorrection import RelativeColorCorrection
from ...corrections.shape.curvature import CurvatureCorrection
from ...corrections.shape.drift import DriftCorrection
from ...image.arithmetics import ones_like
from ...image.image import Image, as_numpy, card_unless
from ...image.imread import imread
from ...measure.integration import ExtrudedPorousGeometry
from ...multiphase.mass_analysis import CO2MassAnalysis
from ...restoration.averaging import porosity_based_averaging
from ...restoration.resize import Resize, resize
from ...signals.models.clipmodel import ClipModel
from ...signals.models.combinedmodel import CombinedModel
from ...utils.morphology import binary_dilation, disk, find_boundaries
from ..analysis.porosity import patched_porosity_analysis
from .config.corrections import CorrectionsConfig, IlluminationCorrectionConfig
from .config.image_porosity import ImagePorosityConfig
from .facies_props import FaciesProps

logger = logging.getLogger(__name__)

__all__ = ["Rig"]


class Rig:
    """Rig object for CO2 analysis."""

    #: Where the rig's images and fields lie (set by setup and load).
    device: torch.device = torch.device("cuda")

    # ------------------------------------------------------ classification

    @property
    def corrections(self) -> list:
        """Combined correction workflow in execution order."""
        return getattr(self, "shape_corrections", []) + getattr(self, "color_corrections", [])

    @staticmethod
    def _is_shape_correction(correction) -> bool:
        return isinstance(correction, (TypeCorrection, Resize, DriftCorrection, CurvatureCorrection))

    @staticmethod
    def _is_color_correction(correction) -> bool:
        return isinstance(
            correction,
            (
                ColorCorrection,
                RelativeColorCorrection,
                IlluminationCorrection,
                PatchwiseIlluminationCorrection,
            ),
        )

    def _imread(self, path, **kwargs) -> Image:
        return imread(path, device=self.device, **kwargs)

    # --------------------------------------------------------------- setup

    def setup_reading(
        self,
        baseline_path: Path,
        experiment,
        corrections_config: Optional[CorrectionsConfig] = None,
        log: Optional[Path] = None,
        show_plot: bool = False,
    ) -> None:
        """Setup shape corrections + the shape-corrected baseline."""
        self.experiment = experiment
        pre_baseline = self._imread(baseline_path)
        self.setup_shape_corrections(pre_baseline=pre_baseline, corrections_config=corrections_config)
        self.shape_corrected_baseline = self._imread(
            baseline_path, transformations=self.shape_corrections
        )
        self.baseline = self.shape_corrected_baseline.copy()
        if log:
            self.baseline.save(Path(log) / "corrected_baseline.npz")
        logger.info("Reading setup completed.")

    def setup_shape_corrections(
        self,
        pre_baseline,
        corrections_config: Optional[CorrectionsConfig] = None,
    ) -> None:
        """Shape corrections independent of labels/porosity."""
        if corrections_config is None:
            corrections_config = CorrectionsConfig()
        self.shape_corrections = []
        baseline_for_setup = pre_baseline

        if corrections_config.type:
            self.type_converter = TypeCorrection(
                np.dtype(corrections_config.type.target_type).type
            )
            baseline_for_setup = self.type_converter(baseline_for_setup)
            self.shape_corrections.append(self.type_converter)

        # Resizing to the baseline's shape keeps every later shape static.
        base_shape = tuple(baseline_for_setup.img.shape[: baseline_for_setup.space_dim])
        self.resize_correction = Resize(shape=base_shape)
        self.resize_correction_inter_nearest = Resize(shape=base_shape, interpolation="inter_nearest")
        self.shape_corrections.append(self.resize_correction)

        if corrections_config.drift:
            try:
                _, cc_voxels = find_colorchecker(
                    baseline_for_setup, corrections_config.drift.colorchecker
                )
                self.drift_correction = DriftCorrection(baseline_for_setup, config={"roi": cc_voxels})
            except Exception as e:
                warn(f"Color checker not found; drift correction inactive: {e}")
                self.drift_correction = DriftCorrection(baseline_for_setup)
            self.shape_corrections.append(self.drift_correction)

        if corrections_config.curvature:
            self.curvature_correction = CurvatureCorrection(
                config=corrections_config.curvature.config
            )
            baseline_for_setup = self.curvature_correction(baseline_for_setup)
            self.shape_corrections.append(self.curvature_correction)

        logger.info("Shape corrections setup complete.")

    def setup_color_corrections(
        self,
        corrections_config: Optional[CorrectionsConfig] = None,
        log: Optional[Path] = None,
        show_plot: bool = False,
    ) -> None:
        """Label-dependent colour corrections; order: illumination ->
        relative colour -> colour."""
        if corrections_config is None:
            corrections_config = CorrectionsConfig()
        if not hasattr(self, "shape_corrected_baseline"):
            raise RuntimeError("Shape-corrected baseline missing. Run setup_shape_corrections.")
        self.color_corrections = []

        if corrections_config.illumination:
            self.illumination_correction = self.setup_illumination_correction(
                corrections_config.illumination, log=log, show_plot=show_plot
            )
            self.color_corrections.append(self.illumination_correction)

        if corrections_config.patchwise_illumination:
            assert not corrections_config.illumination, (
                "Only one illumination correction method at a time."
            )
            self.illumination_correction = self.setup_patchwise_illumination_correction(
                corrections_config.patchwise_illumination
            )
            self.color_corrections.append(self.illumination_correction)

        if corrections_config.relative_color:
            warn("relative_color requested but automated setup is not implemented; skipping.")

        if corrections_config.color:
            try:
                _, cc_voxels = find_colorchecker(
                    self.shape_corrected_baseline, corrections_config.color.colorchecker
                )
                self.color_correction = ColorCorrection(
                    self.shape_corrected_baseline, config={"roi": cc_voxels, "clip": False}
                )
            except Exception as e:
                warn(f"Color checker not found; color correction inactive: {e}")
                self.color_correction = ColorCorrection(self.shape_corrected_baseline)
            self.color_corrections.append(self.color_correction)

        self.baseline = self.shape_corrected_baseline.copy()
        for correction in self.color_corrections:
            self.baseline = correction(self.baseline)
        logger.info("Color corrections setup complete.")

    def load_corrections(
        self,
        folder: Path,
        corrections_config: Optional[CorrectionsConfig] = None,
    ) -> None:
        """Restore the split correction pipelines from a saved rig folder."""
        folder = Path(folder)
        self.shape_corrections = [
            read_correction(file) for file in sorted(folder.glob("shape_correction_*.npz"))
        ]
        self.color_corrections = [
            read_correction(file) for file in sorted(folder.glob("color_correction_*.npz"))
        ]
        for correction in self.shape_corrections:
            if isinstance(correction, CurvatureCorrection):
                self.curvature_correction = correction
            elif isinstance(correction, DriftCorrection):
                self.drift_correction = correction
            elif isinstance(correction, TypeCorrection):
                self.type_converter = correction
            elif isinstance(correction, Resize):
                self.resize_correction = correction
        base_shape = tuple(self.baseline.img.shape[: self.baseline.space_dim])
        self.resize_correction_inter_nearest = Resize(shape=base_shape, interpolation="inter_nearest")

    # ------------------------------------------------------------ geometry

    def setup_depth(self, path: Path, log: Optional[Path] = None) -> None:
        """Load + resample the depth map to the baseline's shape."""
        path = Path(path)
        assert path.exists(), f"Path to depth map {path} does not exist."
        self.depth = resize(self._imread(path), ref_image=self.baseline)
        logger.info("Depth map setup completed.")

    def setup_geometry(self) -> None:
        """Geometry for volumetric integration."""
        self.geometry = ExtrudedPorousGeometry(
            depth=self.depth, porosity=self.porosity, **self.baseline.shape_metadata()
        )
        logger.info("Geometry setup completed.")

    # -------------------------------------------------------------- labels

    def _load_label_field(self, path: Path, apply_corrections: bool):
        assert Path(path).exists(), f"File {path} does not exist."
        if apply_corrections:
            field = self._imread(path)
            if hasattr(self, "resize_correction_inter_nearest"):
                field = self.resize_correction_inter_nearest(field)
            if hasattr(self, "curvature_correction"):
                field = self.curvature_correction(field)
            return field
        return resize(self._imread(path), ref_image=self.baseline, interpolation="inter_nearest")

    def setup_labels(
        self,
        path: Path,
        apply_corrections: bool = False,
        log: Optional[Path] = None,
    ) -> None:
        self.labels = self._load_label_field(path, apply_corrections)
        logger.info("Labels setup completed.")

    def setup_inner_labels(self, log: Optional[Path] = None) -> None:
        """Boolean mask excluding (dilated) label boundaries (host
        morphology, the mask on the labels' device)."""
        boundary = find_boundaries(as_numpy(self.labels.img))
        buffer_zone = binary_dilation(boundary, footprint=disk(2))
        self.inner_labels = Image(
            ~buffer_zone.astype(bool), device=self.labels.img.device, **self.labels.metadata()
        )

    def setup_facies(
        self,
        path: Path,
        apply_corrections: bool = False,
        log: Optional[Path] = None,
        show_plot: bool = False,
    ) -> None:
        self.facies = self._load_label_field(path, apply_corrections)
        logger.info("Facies setup completed.")

    def setup_facies_props(
        self,
        props_path: Optional[Path] = None,
        porosity: Optional[Path] = None,
        permeability: Optional[Path] = None,
    ) -> None:
        if props_path:
            facies_props = FaciesProps.load(facies=self.facies, path=props_path)
            self.porosity = facies_props.porosity
            self.permeability = facies_props.permeability
        elif porosity and permeability:
            self.porosity = self._imread(porosity)
            self.permeability = self._imread(permeability)
        else:
            # Default: unit porosity/permeability (float32, as the JAX
            # package's arrays are).
            self.porosity = ones_like(self.facies, mode="voxels", dtype=np.float32)
            self.permeability = ones_like(self.facies, mode="voxels", dtype=np.float32)

    # -------------------------------------------------------- illumination

    def setup_illumination_correction(
        self,
        config: Optional[IlluminationCorrectionConfig],
        log: Optional[Path] = None,
        show_plot: bool = False,
    ) -> IlluminationCorrection:
        """Calibrate the illumination correction on the shape-corrected
        baseline."""
        from scipy import ndimage

        illumination_correction = IlluminationCorrection()
        if config is not None:
            sample_groups = []
            if not config.labels:
                shape = tuple(self.shape_corrected_baseline.img.shape[:2])
                sample_groups.append(
                    illumination_correction.select_random_samples(
                        mask=np.ones(shape, dtype=bool), config=config
                    )
                )
            else:
                labels_arr = as_numpy(self.labels.img)
                for label in config.labels:
                    assert label in labels_arr, f"Label {label} not found."
                    sample_groups.append(
                        illumination_correction.select_random_samples(
                            mask=labels_arr == label, config=config
                        )
                    )
            illumination_correction.setup(
                base=self.shape_corrected_baseline,
                sample_groups=sample_groups,
                mask=self.boolean_porosity,
                outliers=config.outliers,
                filter=lambda x: ndimage.gaussian_filter(x, sigma=config.sigma),
                colorspace=config.colorspace,
                interpolation=config.interpolation,
                show_plot=show_plot,
                log=log,
            )
        return illumination_correction

    def setup_patchwise_illumination_correction(
        self, config, show_plot: bool = False
    ) -> PatchwiseIlluminationCorrection:
        image = self.read_image(config.image_path)
        baseline_images = [self.read_image(p) for p in config.baseline_paths]
        return PatchwiseIlluminationCorrection(
            image=image,
            baseline_images=baseline_images,
            nw=config.nw,
            limit=config.limit,
            eps=config.eps,
            show_images=show_plot,
        )

    # ------------------------------------------------------------ porosity

    def setup_image_porosity(
        self,
        path: Optional[Path] = None,
        log: Optional[Path] = None,
        config: Optional[ImagePorosityConfig] = None,
        show_plot: bool = False,
    ) -> None:
        """Image porosity: full (all ones) or derived from the baseline."""
        if config is None:
            config = ImagePorosityConfig()
        self._image_porosity_config = config
        if path is not None:
            self.image_porosity = self._imread(path)
        elif config.mode == "from_image":
            self.image_porosity = patched_porosity_analysis(
                baseline=self.baseline,
                patches=tuple(config.patches),
                labels=self.labels,
                num_clusters=config.num_clusters,
                sample_width=config.sample_width,
                tol_color_distance=config.tol_color_distance,
                tol_color_gradient=config.tol_color_gradient,
            )
        else:
            self.image_porosity = ones_like(self.baseline, mode="voxels", dtype=np.float32)
        logger.info("Porosity setup completed.")

    def setup_boolean_image_porosity(
        self,
        threshold: Optional[float] = None,
        log: Optional[Path] = None,
        config: Optional[ImagePorosityConfig] = None,
        show_plot: bool = False,
    ) -> None:
        """Threshold the image porosity."""
        if config is None:
            config = getattr(self, "_image_porosity_config", ImagePorosityConfig())
        tol = threshold if threshold is not None else config.tol
        if config.mode == "full":
            self.boolean_porosity = ones_like(self.baseline, mode="voxels", dtype=bool)
        else:
            out = self.image_porosity.copy()
            out.img = self.image_porosity.img > tol
            self.boolean_porosity = out
        logger.info("Boolean porosity setup completed.")

    # ----------------------------------------------------------- full setup

    def setup(
        self,
        experiment,
        baseline_path: Path,
        depth_map_path: Path,
        labels_path: Path,
        facies_path: Optional[Path] = None,
        facies_props_path: Optional[Path] = None,
        corrections_config: Optional[CorrectionsConfig] = None,
        image_porosity_config: Optional[ImagePorosityConfig] = None,
        log: Optional[Path] = None,
        show_plot: bool = False,
        device=None,
    ) -> None:
        """Full set-up of the rig on ``device`` (None: the card)."""
        self.device = card_unless(device, "the rig")
        if log:
            Path(log).mkdir(parents=True, exist_ok=True)
        self.baseline_path = Path(baseline_path)
        self.reference_date = experiment.experiment_start

        self.setup_reading(
            baseline_path,
            experiment,
            corrections_config=corrections_config,
            log=log,
            show_plot=show_plot,
        )
        self.setup_depth(depth_map_path, log=log)
        self.setup_labels(path=labels_path, apply_corrections=True, log=log)
        self.setup_inner_labels(log=log)
        if facies_path is not None:
            self.setup_facies(path=facies_path, apply_corrections=True, log=log, show_plot=show_plot)
        else:
            self.facies = self.labels.copy()
        self.setup_facies_props(facies_props_path)
        self.setup_geometry()
        self.setup_image_porosity(log=log, config=image_porosity_config, show_plot=show_plot)
        self.setup_boolean_image_porosity(log=log, show_plot=show_plot)
        self.setup_color_corrections(
            corrections_config=corrections_config, log=log, show_plot=show_plot
        )
        if self.color_corrections:
            self.setup_image_porosity(log=log, config=image_porosity_config, show_plot=show_plot)
            self.setup_boolean_image_porosity(log=log, show_plot=show_plot)

        # Porosity-based averaging for restoration/upscaling.
        restoration = porosity_based_averaging(self.labels, self.image_porosity, self.baseline)
        self.restoration = restoration
        self.upscaling = CombinedModel([ClipModel(min_value=0.0)] + 2 * [restoration])
        logger.info("Rig setup completed.")

    # -------------------------------------------------------- mass analysis

    def setup_mass_analysis(self, atmospheric_pressure, atmospheric_temperature) -> None:
        self.co2_mass_analysis = CO2MassAnalysis(
            self.baseline,
            atmospheric_pressure=atmospheric_pressure,
            atmospheric_temperature=atmospheric_temperature,
        )
        logger.info("Mass analysis setup completed.")

    def mass_analysis(self, img):
        raise NotImplementedError

    def threshold_analysis(self, mass_analysis_result):
        raise NotImplementedError

    # ------------------------------------------------------------------- io

    def save(self, folder: Path) -> None:
        """Persist the rig: the JAX package's folder layout."""
        folder = Path(folder)
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "meta_data.json").write_text(
            json.dumps({"baseline_path": str(getattr(self, "baseline_path", ""))})
        )
        self.baseline.save(folder / "baseline.npz")
        if hasattr(self, "shape_corrected_baseline"):
            self.shape_corrected_baseline.save(folder / "shape_corrected_baseline.npz")
        for i, correction in enumerate(getattr(self, "shape_corrections", [])):
            name = type(correction).__name__.lower()
            correction.save(folder / f"shape_correction_{i}_{name}.npz")
        for i, correction in enumerate(getattr(self, "color_corrections", [])):
            name = type(correction).__name__.lower()
            correction.save(folder / f"color_correction_{i}_{name}.npz")
        for attr, filename in (
            ("depth", "depth.npz"),
            ("labels", "labels.npz"),
            ("facies", "facies.npz"),
            ("porosity", "porosity.npz"),
            ("permeability", "permeability.npz"),
            ("image_porosity", "image_porosity.npz"),
        ):
            try:
                getattr(self, attr).save(folder / filename)
            except Exception:
                warn(f"{attr} not available for saving.")
        logger.info("Rig object saved to %s.", folder)

    @classmethod
    def load(
        cls,
        folder: Path,
        corrections_config: Optional[CorrectionsConfig] = None,
        device=None,
    ) -> "Rig":
        """Restore a saved rig (either package's folder) on ``device``
        (None: the card)."""
        folder = Path(folder)
        rig = cls()
        rig.device = card_unless(device, "the rig")
        meta = json.loads((folder / "meta_data.json").read_text())
        rig.baseline_path = Path(meta["baseline_path"])
        rig.baseline = rig._imread(folder / "baseline.npz")
        if (folder / "shape_corrected_baseline.npz").exists():
            rig.shape_corrected_baseline = rig._imread(folder / "shape_corrected_baseline.npz")
        else:
            rig.shape_corrected_baseline = rig.baseline.copy()
        rig.load_corrections(folder, corrections_config=corrections_config)
        rig.setup_depth(path=folder / "depth.npz")
        rig.setup_labels(path=folder / "labels.npz", apply_corrections=False)
        rig.setup_inner_labels()
        rig.setup_facies(path=folder / "facies.npz", apply_corrections=False)
        rig.setup_facies_props(
            porosity=folder / "porosity.npz", permeability=folder / "permeability.npz"
        )
        rig.setup_geometry()
        rig.setup_image_porosity(path=folder / "image_porosity.npz")
        rig.setup_boolean_image_porosity()
        logger.info("Rig object loaded.")
        return rig

    # ------------------------------------------------------------- reading

    def import_from_csv(
        self,
        path: Path,
        *,
        delimiter: str = ",",
        date=None,
        reference_date=None,
        time=None,
        name: Optional[str] = None,
        is_extensive: bool = False,
    ):
        """Import scalar result data from a coordinate CSV: columns (x, y,
        value), lex-sorted so x changes fastest, reshaped row-major and
        flipped to the image's top-left-origin row/col convention; the
        image lies on the rig's device."""
        from ...image.image import ExtensiveImage, ScalarImage

        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"CSV file {path} does not exist.")
        try:
            data = np.loadtxt(path, delimiter=delimiter)
        except ValueError:
            data = np.loadtxt(path, delimiter=delimiter, skiprows=1)
        data = data[np.lexsort((data[:, 0], data[:, 1]))]
        coordinates_x, coordinates_y, values = data[:, 0], data[:, 1], data[:, 2]

        unique_x = np.unique(coordinates_x)
        unique_y = np.unique(coordinates_y)
        shape = (len(unique_y), len(unique_x))
        dx = float(np.min(np.diff(unique_x)))
        dy = float(np.min(np.diff(unique_y)))
        origin = (unique_x[0] - dx / 2, unique_y[-1] + dy / 2)
        dimensions = (
            float(np.max(coordinates_y) - np.min(coordinates_y) + dy),
            float(np.max(coordinates_x) - np.min(coordinates_x) + dx),
        )
        # x changes fastest -> C-order reshape, then flip rows so the top
        # row holds the largest y (image row/col convention).
        values_reshaped = np.ascontiguousarray(np.flip(values.reshape(shape, order="C"), axis=0))

        metadata = {
            "origin": origin,
            "dimensions": dimensions,
            "name": name,
            "time": time,
            "date": date,
            "reference_date": reference_date,
            "series": False,
            "scalar": True,
        }
        klass = ExtensiveImage if is_extensive else ScalarImage
        return klass(values_reshaped, device=self.device, **metadata)

    def read_images(self, paths, depth=None):
        """The prefetching reader of a series (``utils/prefetch.py``) is not
        ported yet."""
        raise NotImplementedError(
            "Rig.read_images needs utils/prefetch.py (the host loader), which is not ported "
            "yet (ROADMAP.md Queue 1 item 7c); call read_image per path"
        )

    def read_image(self, path: Path) -> Image:
        """Read + correct an image on the rig's device; the date comes from
        the imaging protocol."""
        assert hasattr(self, "experiment"), "Experiment not defined. Run load_experiment() first."
        path = Path(path)
        return self._imread(
            path,
            transformations=self.corrections,
            date=self.experiment.get_datetime(path),
            reference_date=getattr(self, "reference_date", None),
            name=path.name,
        )

    def load_experiment(self, experiment) -> None:
        self.experiment = experiment
        self.injection_protocol = experiment.injection_protocol
        self.pressure_temperature_protocol = experiment.pressure_temperature_protocol
        self.reference_date = experiment.experiment_start
        logger.info("Experiment and protocols loaded.")

    def update(self, path: Path) -> None:
        """Update current date/time/pressure/temperature from an image path."""
        date = self.experiment.get_datetime(Path(path))
        self.current_date = date
        self.current_time = (date - self.reference_date).total_seconds() / 3600.0
        state = self.pressure_temperature_protocol.get_state(date)
        self.current_pressure = state.pressure
        self.current_temperature = state.temperature
        self.setup_mass_analysis(
            atmospheric_pressure=self.current_pressure,
            atmospheric_temperature=self.current_temperature,
        )
        logger.info("State updated to %s.", self.current_date)
