"""Segmentation (contour overlay) workflow step.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_segmentation`.
Its only product is a figure per photograph and configured entry (the
contours of the thresholded mode image over the photograph), drawn with
matplotlib: where matplotlib does not import, the step raises, naming it,
before it reads a photograph.  The masks are computed on the rig's device
(``SegmentationContours.extract_mask``); only they come to the host.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

from ....utils.optional import optional_module
from ..segmentation_contours import SegmentationContours
from .analysis_context import AnalysisContext, prepare_analysis_context
from .progress import publish_image_progress, publish_step_complete, publish_step_start
from .scalar_products import analysis_scalar_products

logger = logging.getLogger(__name__)

__all__ = ["analysis_segmentation_from_context", "analysis_segmentation"]


def require_matplotlib(step: str) -> None:
    """Raise, naming matplotlib, where it does not import: the ``step``
    analysis draws nothing else."""
    optional_module("matplotlib", f"the {step} analysis (its figures)")


def analysis_segmentation_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
) -> None:
    from .analysis_context import iter_prefetched_images

    require_matplotlib("segmentation")
    config = ctx.config
    assert config.analysis is not None
    seg_config = config.analysis.segmentation
    if seg_config is None:
        raise ValueError("Segmentation requires [analysis.segmentation].")
    entries = (
        seg_config.config
        if isinstance(seg_config.config, dict)
        else {"default": seg_config.config}
    )
    folder = Path(seg_config.folder)
    folder.mkdir(parents=True, exist_ok=True)

    needs_mass = ctx.color_to_mass_analysis is not None
    publish_step_start(
        progress_callback, step="segmentation", image_total=len(ctx.image_paths)
    )
    started = time.monotonic()
    for index, path, img in iter_prefetched_images(ctx):
        t0 = time.monotonic()
        if img is None:
            continue
        mass_result = (
            ctx.color_to_mass_analysis(img) if needs_mass else None
        )
        scalar_products = None
        if mass_result is not None:
            products, _ = analysis_scalar_products(
                mass_analysis_result=mass_result,
                expert_knowledge_adapter=ctx.expert_knowledge_adapter,
            )
            scalar_products = products
        for key, entry in entries.items():
            contours = SegmentationContours(entry)
            out = folder / key
            out.mkdir(parents=True, exist_ok=True)
            contours(
                img,
                background=img,
                path=out / f"{path.stem}.jpg",
                mass_analysis_result=mass_result,
                color_embedding_registry=config.color,
                color_embedding_runtime=ctx.color_embedding_runtime,
                scalar_products=scalar_products,
            )
        publish_image_progress(
            progress_callback,
            step="segmentation",
            image_path=str(path),
            image_index=index,
            image_total=len(ctx.image_paths),
            image_duration_s=time.monotonic() - t0,
        )
    publish_step_complete(
        progress_callback,
        step="segmentation",
        step_elapsed_s=time.monotonic() - started,
    )


def analysis_segmentation(
    path, cls=None, all: bool = False, require_color_to_mass: bool = True, device=None, **kwargs
) -> None:
    from ..rig import Rig

    require_matplotlib("segmentation")
    ctx = prepare_analysis_context(
        cls=cls or Rig,
        path=path,
        all=all,
        require_color_to_mass=require_color_to_mass,
        device=device,
    )
    analysis_segmentation_from_context(ctx, **kwargs)
