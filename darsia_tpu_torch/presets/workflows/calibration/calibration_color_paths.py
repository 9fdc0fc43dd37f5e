"""Colour-path calibration step.

Counterpart of
:mod:`darsia_tpu.presets.workflows.calibration.calibration_color_paths`:
the baseline photographs' spectrum (the colours to ignore) -> the
calibration photographs' spectra -> one relative colour path per label ->
the ``LabelColorPathMap`` folder and its metadata.  The photographs are read
through the rig's corrections on its device (prefetched on worker threads,
in order; a read that fails raises), and the spectra are gathered there
(``signals/color/color_path_regression.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from types import SimpleNamespace

from ....signals.color import ColorPathEmbedding, LabelColorPathMapRegression
from ....utils.prefetch import prefetch_map
from ....utils.standard_images import roi_to_mask
from ..analysis.analysis_context import (
    AnalysisContext,
    prepare_analysis_context,
    select_image_paths,
)
from .metadata import write_calibration_metadata

logger = logging.getLogger(__name__)

__all__ = [
    "calibration_color_paths_from_context",
    "calibration_color_paths",
    "collect_existing_calibration_paths_to_delete",
    "delete_calibration",
]


def _read_images(rig, paths) -> list:
    """Every photograph of ``paths`` through the rig's corrections, in
    order; the first read that fails raises."""
    images = []
    for result in prefetch_map(rig.read_image, [Path(p) for p in paths]):
        if not result.ok:
            raise result.error
        images.append(result.value)
    return images


def calibration_color_paths_from_context(ctx: AnalysisContext, show: bool = False) -> None:
    config = ctx.config
    experiment = ctx.experiment
    fluidflower = ctx.fluidflower
    config.check("rig", "data", "protocol", "color", "calibration")
    assert config.calibration is not None and config.calibration.color is not None
    embedding = config.calibration.color.color
    if not isinstance(embedding, ColorPathEmbedding):
        raise NotImplementedError("calibration.color currently supports only color path embeddings.")

    labels = embedding.get_labels(fluidflower)

    baseline_paths = (
        select_image_paths(config, experiment, sub_config=SimpleNamespace(data=embedding.baseline_data))
        if embedding.baseline_data is not None
        else []
    )
    baseline_images = _read_images(fluidflower, baseline_paths)
    calibration_images = _read_images(fluidflower, ctx.image_paths)

    # The calibration mask: the boolean porosity, restricted to the ROIs.
    calibration_mask = fluidflower.boolean_porosity.copy()
    if embedding.rois and config.roi_registry is not None:
        roi_entries = config.roi_registry.resolve_rois(embedding.rois)
        union = roi_to_mask([entry.roi for entry in roi_entries.values()], calibration_mask)
        combined = calibration_mask.img.to(bool) & union.img.to(calibration_mask.img.device)
        if not bool(combined.any()):
            logger.warning("ROI union does not overlap the porosity mask; using the full porosity mask.")
        else:
            calibration_mask.img = combined

    regression = LabelColorPathMapRegression(
        labels=labels,
        resolution=embedding.resolution,
        mask=calibration_mask,
        ignore_labels=embedding.ignore_labels,
    )

    ignore_spectrum = None
    if embedding.ignore_baseline_spectrum != "none" and baseline_images:
        ignore_spectrum = regression.get_color_spectrum(
            baseline_images[1:] or baseline_images,
            baseline=baseline_images[0],
            threshold_zero=embedding.threshold_baseline,
        )
        if embedding.ignore_baseline_spectrum == "expanded":
            ignore_spectrum = regression.expand_color_spectrum(ignore_spectrum)

    baseline = baseline_images[0] if baseline_images else fluidflower.baseline
    spectra = regression.get_color_spectrum(
        calibration_images,
        baseline=baseline,
        ignore=ignore_spectrum,
        threshold_zero=embedding.threshold_calibration,
    )
    color_paths = regression.find_color_path(
        spectra,
        num_segments=embedding.num_segments,
        weighting=embedding.histogram_weighting,
    )
    color_paths.save(embedding.color_paths_folder)
    write_calibration_metadata(
        embedding.color_paths_folder,
        embedding.basis,
        extra={"embedding_id": embedding.embedding_id},
    )
    logger.info("Color paths saved to %s (%d labels).", embedding.color_paths_folder, len(color_paths))


def calibration_color_paths(path, cls=None, show: bool = False, device=None) -> None:
    """The colour-path calibration of a TOML config on ``device`` (None: the
    CUDA card)."""
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="calibration", device=device)
    calibration_color_paths_from_context(ctx, show=show)


def collect_existing_calibration_paths_to_delete(path) -> list:
    """All persisted calibration artifacts under results/calibration."""
    from ..config.fluidflower_config import FluidFlowerConfig

    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    if config.data is None:
        return []
    root = Path(config.data.results) / "calibration"
    return sorted(p for p in root.rglob("*") if p.is_file())


def delete_calibration(path, dry_run: bool = False) -> list:
    files = collect_existing_calibration_paths_to_delete(path)
    if not dry_run:
        for file in files:
            file.unlink()
    return files
