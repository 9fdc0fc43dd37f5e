"""Thresholding workflow step: layered overlays with legend.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_thresholding`.
Its only product is a figure per photograph (layer fills, strokes, a
legend), drawn with matplotlib: where matplotlib does not import, the step
raises, naming it, before it reads a photograph.  Each layer's mask is
computed on the rig's device (:func:`layer_mask`); only the masks come to
the host.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ....image.image import as_numpy
from ....utils.optional import optional_module
from ..mode_resolution import mode_requires_color_to_mass, resolve_mode_image
from .analysis_context import AnalysisContext, prepare_analysis_context
from .analysis_segmentation import require_matplotlib
from .progress import publish_image_progress, publish_step_complete, publish_step_start
from .scalar_products import analysis_scalar_products

logger = logging.getLogger(__name__)

__all__ = ["analysis_thresholding_from_context", "analysis_thresholding"]


def layer_mask(layer, field: torch.Tensor) -> torch.Tensor:
    """The pixels of ``field`` within the layer's bounds, on its device."""
    mask = torch.ones(field.shape, dtype=torch.bool, device=field.device)
    if layer.threshold_min is not None:
        mask &= field >= layer.threshold_min
    if layer.threshold_max is not None:
        mask &= field <= layer.threshold_max
    return mask


def analysis_thresholding_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
) -> None:
    from .analysis_context import iter_prefetched_images

    require_matplotlib("thresholding")
    optional_module("matplotlib", "the thresholding analysis").use("Agg")
    mpatches = optional_module("matplotlib.patches", "the thresholding analysis")
    plt = optional_module("matplotlib.pyplot", "the thresholding analysis")

    config = ctx.config
    assert config.analysis is not None
    thresholding = config.analysis.thresholding
    if thresholding is None:
        raise ValueError("Thresholding requires [analysis.thresholding].")
    folder = Path(thresholding.folder)
    folder.mkdir(parents=True, exist_ok=True)

    needs_mass = any(
        mode_requires_color_to_mass(layer.mode)
        for layer in thresholding.layers.values()
    )
    requested_rescaled = {
        layer.mode
        for layer in thresholding.layers.values()
        if layer.mode.startswith("rescaled_")
    }

    publish_step_start(
        progress_callback, step="thresholding", image_total=len(ctx.image_paths)
    )
    started = time.monotonic()
    for index, path, img in iter_prefetched_images(ctx):
        t0 = time.monotonic()
        if img is None:
            continue
        mass_result = None
        scalar_products = None
        if needs_mass:
            assert ctx.color_to_mass_analysis is not None
            mass_result = ctx.color_to_mass_analysis(img)
            products, _ = analysis_scalar_products(
                mass_analysis_result=mass_result,
                requested_modes=requested_rescaled,
                geometry=ctx.fluidflower.geometry,
                injection_protocol=ctx.experiment.injection_protocol,
                co2_mass_analysis=ctx.color_to_mass_analysis.co2_mass_analysis,
                date=img.date,
                expert_knowledge_adapter=ctx.expert_knowledge_adapter,
            )
            scalar_products = products

        fig, ax = plt.subplots()
        ax.imshow(np.clip(as_numpy(img.img), 0, 1))
        handles = []
        for key, layer in thresholding.layers.items():
            field_img = resolve_mode_image(
                layer.mode,
                img,
                mass_analysis_result=mass_result,
                color_embedding_registry=config.color,
                color_embedding_runtime=ctx.color_embedding_runtime,
                scalar_products=scalar_products,
            )
            mask = as_numpy(layer_mask(layer, field_img.img))
            fill = np.clip(np.asarray(layer.fill, float) / 255.0, 0, 1)
            stroke = np.clip(np.asarray(layer.stroke, float) / 255.0, 0, 1)
            overlay = np.zeros(mask.shape + (4,))
            overlay[mask] = [*fill, layer.fill_alpha]
            ax.imshow(overlay)
            ax.contour(
                mask.astype(float),
                levels=[0.5],
                colors=[tuple(stroke)],
                linewidths=layer.stroke_width,
            )
            handles.append(
                mpatches.Patch(color=tuple(fill), label=layer.label or key)
            )
        if thresholding.legend.show and handles:
            ax.legend(
                handles=handles,
                loc="upper left",
                fontsize=8 * thresholding.legend.font_scale / 0.7,
                framealpha=thresholding.legend.box_alpha
                if thresholding.legend.box_enabled
                else 0.0,
            )
        ax.set_axis_off()
        fig.savefig(folder / f"{path.stem}.jpg", dpi=200, bbox_inches="tight")
        plt.close(fig)

        publish_image_progress(
            progress_callback,
            step="thresholding",
            image_path=str(path),
            image_index=index,
            image_total=len(ctx.image_paths),
            image_duration_s=time.monotonic() - t0,
        )
    publish_step_complete(
        progress_callback,
        step="thresholding",
        step_elapsed_s=time.monotonic() - started,
    )


def analysis_thresholding(
    path, cls=None, all: bool = False, require_color_to_mass: bool = True, device=None, **kwargs
) -> None:
    from ..rig import Rig

    require_matplotlib("thresholding")
    ctx = prepare_analysis_context(
        cls=cls or Rig,
        path=path,
        all=all,
        require_color_to_mass=require_color_to_mass,
        device=device,
    )
    analysis_thresholding_from_context(ctx, **kwargs)
