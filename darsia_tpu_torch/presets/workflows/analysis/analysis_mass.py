"""Mass analysis workflow step: the per-image hot loop.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_mass`:
read (prefetched on worker threads) -> colour-to-mass -> rescale to the
injected mass -> export fields -> integrate ROIs -> append the CSV row.
The fields stay on the rig's device until the export copies them to the
host; each integral is one float read.

pandas is not part of the port's environment: the CSV is written with the
``csv`` module cell for cell as the JAX package's ``DataFrame.to_csv``
writes it (``utils/csv_table.py``); an existing CSV is read back, the rows
appended and the whole sorted by ``time``, as the JAX loop does.  The step
returns the rows as a list of dicts in the CSV's order, where the JAX package
returns the frame: ``pandas.DataFrame(rows)`` gives that frame.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Callable, Optional

from ....utils.csv_table import CsvTable
from .analysis_context import AnalysisContext, prepare_analysis_context
from .image_export_formats import ImageExportFormats
from .progress import publish_image_progress, publish_step_complete, publish_step_start
from .scalar_products import analysis_scalar_products
from .streaming import publish_stream_images

logger = logging.getLogger(__name__)

__all__ = ["analysis_mass", "analysis_mass_from_context", "run_mass_analysis"]

_DEFAULT_MASS_EXPORT_MODES = ["mass"]


def analysis_mass_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
) -> list:
    """Run the mass hot loop over ``ctx.image_paths``; returns the CSV's
    rows (dicts, in the file's order)."""
    assert ctx.config.analysis is not None
    assert ctx.color_to_mass_analysis is not None
    config = ctx.config
    experiment = ctx.experiment
    fluidflower = ctx.fluidflower
    color_to_mass_analysis = ctx.color_to_mass_analysis
    co2_mass_analysis = color_to_mass_analysis.co2_mass_analysis
    if config.analysis.mass is None:
        raise ValueError("Mass analysis requires an [analysis.mass] section.")

    # Sub-geometries for ROI integration.
    geometry = {
        roi_config.name or key: fluidflower.geometry.subregion(roi_config.roi)
        for key, roi_config in config.analysis.mass.roi.items()
    }

    export_modes = list(config.analysis.mass.export or _DEFAULT_MASS_EXPORT_MODES)
    exporter = ImageExportFormats.from_analysis_config(config.analysis, config.format_registry)
    output_folders = {mode: Path(config.analysis.mass.folder) / mode for mode in export_modes}
    for folder in output_folders.values():
        folder.mkdir(parents=True, exist_ok=True)
    csv_path = Path(config.analysis.mass.folder) / "mass_analysis_results.csv"
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    table = CsvTable.read_or_empty(csv_path)

    image_paths = list(ctx.image_paths)
    if config.analysis.random_traverse:
        random.shuffle(image_paths)

    publish_step_start(progress_callback, step="mass", image_total=len(image_paths))
    step_started = time.monotonic()

    from .analysis_context import iter_prefetched_images

    for image_index, path, img in iter_prefetched_images(ctx, image_paths):
        image_started = time.monotonic()
        if img is None:
            continue
        result = color_to_mass_analysis(img)
        image_time = result.time

        products, rescaled = analysis_scalar_products(
            mass_analysis_result=result,
            requested_modes={
                "rescaled_mass",
                "rescaled_saturation_g",
                "rescaled_concentration_aq",
            },
            geometry=fluidflower.geometry,
            injection_protocol=experiment.injection_protocol,
            co2_mass_analysis=co2_mass_analysis,
            date=img.date,
            expert_knowledge_adapter=ctx.expert_knowledge_adapter,
        )
        mass = products["mass_total"]
        mass_g = products["mass_g"]
        mass_aq = products["mass_aq"]

        export_images = dict(products)
        if "extensive_mass" in export_modes:
            export_images["extensive_mass"] = fluidflower.geometry.make_extensive(mass)
        if "extensive_rescaled_mass" in export_modes:
            export_images["extensive_rescaled_mass"] = fluidflower.geometry.make_extensive(
                products["rescaled_mass"]
            )
        for mode in export_modes:
            exporter.export(export_images[mode], output_folders[mode], path.stem)

        row = {
            "time": float(image_time) if image_time is not None else None,
            "datetime": img.date,
            "image_stem": path.stem,
            "detected_mass_total": rescaled.detected_mass_total,
            "exact_mass_total": rescaled.exact_mass_total,
            "detected_mass_total_rescaled": float(
                fluidflower.geometry.integrate(products["rescaled_mass"])
            ),
            "mass_scaling_factor": rescaled.mass_scaling_factor,
        }
        for key, roi_config in config.analysis.mass.roi.items():
            name = roi_config.name or key
            roi = roi_config.roi
            row[f"{name}_exact_mass"] = float(
                experiment.injection_protocol.injected_mass(date=img.date, roi=roi)
            )
            row[f"{name}_detected_mass"] = float(geometry[name].integrate(mass.subregion(roi)))
            row[f"{name}_detected_mass_g"] = float(geometry[name].integrate(mass_g.subregion(roi)))
            row[f"{name}_detected_mass_aq"] = float(
                geometry[name].integrate(mass_aq.subregion(roi))
            )

        table.append(row)
        table.sort_by("time")
        table.write(csv_path)
        logger.info("Processed %s at time %s", path.stem, image_time)

        publish_stream_images(
            stream_callback=stream_callback,
            image_payload={
                "mass_source_image": img,
                "mass_total": mass,
                "rescaled_mass": products.get("rescaled_mass"),
            },
            logger=logger,
            error_message=f"Failed to stream mass previews for '{path}'.",
        )
        publish_image_progress(
            progress_callback,
            step="mass",
            image_path=str(path),
            image_index=image_index,
            image_total=len(image_paths),
            image_duration_s=time.monotonic() - image_started,
        )

    publish_step_complete(
        progress_callback, step="mass", step_elapsed_s=time.monotonic() - step_started
    )
    return table.records()


def run_mass_analysis(path, cls=None, all: bool = False, device=None, **kwargs):
    """Prepare the context on ``device`` (None: the CUDA card) and run the
    mass loop."""
    from ..rig import Rig

    ctx = prepare_analysis_context(
        cls=cls or Rig, path=path, all=all, require_color_to_mass=True, device=device
    )
    return analysis_mass_from_context(ctx, **kwargs)


def analysis_mass(
    cls, path, show: bool = False, all: bool = False, stream_callback=None, device=None
):
    """Standalone mass-analysis entry point (the JAX package's argument
    order)."""
    return run_mass_analysis(
        path, cls=cls, all=all, device=device, show=show, stream_callback=stream_callback
    )
