"""Volume analysis workflow step: gas volume per ROI over time.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_volume`.
The CSV is written as the mass step writes it (``utils/csv_table.py``, no
pandas); the step returns its rows as dicts in the file's order.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

from ....utils.csv_table import CsvTable
from .analysis_context import AnalysisContext, iter_prefetched_images, prepare_analysis_context
from .progress import publish_image_progress, publish_step_complete, publish_step_start

logger = logging.getLogger(__name__)

__all__ = ["analysis_volume_from_context", "analysis_volume"]


def analysis_volume_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
) -> list:
    config = ctx.config
    fluidflower = ctx.fluidflower
    assert config.analysis is not None
    assert ctx.color_to_mass_analysis is not None
    volume_config = config.analysis.volume
    rois = volume_config.roi if volume_config is not None else {}
    folder = (
        Path(volume_config.folder)
        if volume_config is not None
        else Path(config.data.results) / "volume"
    )
    folder.mkdir(parents=True, exist_ok=True)
    csv_path = folder / "volume_analysis_results.csv"
    table = CsvTable.read_or_empty(csv_path)

    geometry = {
        (roi.name or key): fluidflower.geometry.subregion(roi.roi) for key, roi in rois.items()
    }

    publish_step_start(progress_callback, step="volume", image_total=len(ctx.image_paths))
    started = time.monotonic()
    for index, path, img in iter_prefetched_images(ctx):
        t0 = time.monotonic()
        if img is None:
            continue
        result = ctx.color_to_mass_analysis(img)
        saturation = result.saturation_g
        row = {
            "time": float(result.time) if result.time is not None else None,
            "image_stem": path.stem,
            "volume_g_total": float(fluidflower.geometry.integrate(saturation)),
        }
        for key, roi in rois.items():
            name = roi.name or key
            row[f"{name}_volume_g"] = float(geometry[name].integrate(saturation.subregion(roi.roi)))
        table.append(row)
        table.sort_by("time")
        table.write(csv_path)
        publish_image_progress(
            progress_callback,
            step="volume",
            image_path=str(path),
            image_index=index,
            image_total=len(ctx.image_paths),
            image_duration_s=time.monotonic() - t0,
        )
    publish_step_complete(progress_callback, step="volume", step_elapsed_s=time.monotonic() - started)
    return table.records()


def analysis_volume(path, cls=None, all: bool = False, device=None, **kwargs):
    from ..rig import Rig

    ctx = prepare_analysis_context(
        cls=cls or Rig, path=path, all=all, require_color_to_mass=True, device=device
    )
    return analysis_volume_from_context(ctx, **kwargs)
