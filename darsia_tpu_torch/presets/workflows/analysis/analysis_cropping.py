"""Cropping workflow step: export the corrected (cropped) photographs.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_cropping`.
``npz`` goes through ``Image.save``; ``jpg`` needs matplotlib and raises
``ImportError`` naming it where it does not import (the card's machine).  Without ``[analysis.cropping]`` the format is jpg, as in the JAX
package.
"""

from __future__ import annotations

import importlib
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ....image.image import as_numpy
from ....utils.optional import optional_module
from .analysis_context import AnalysisContext, iter_prefetched_images, prepare_analysis_context
from .progress import publish_image_progress, publish_step_complete, publish_step_start
from .streaming import publish_stream_images

logger = logging.getLogger(__name__)

__all__ = ["analysis_cropping_from_context", "analysis_cropping"]


def analysis_cropping_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
) -> None:
    config = ctx.config
    assert config.analysis is not None and config.data is not None
    formats = (
        config.analysis.cropping.formats if config.analysis.cropping is not None else ["jpg"]
    )
    out = Path(config.data.results) / "cropped"
    out.mkdir(parents=True, exist_ok=True)

    publish_step_start(progress_callback, step="cropping", image_total=len(ctx.image_paths))
    started = time.monotonic()
    for index, path, img in iter_prefetched_images(ctx):
        t0 = time.monotonic()
        if img is None:
            continue
        if "jpg" in formats:
            matplotlib = optional_module("matplotlib", "writing jpg files")
            matplotlib.use("Agg")
            plt = importlib.import_module("matplotlib.pyplot")
            plt.imsave(out / f"{path.stem}.jpg", np.clip(as_numpy(img.img), 0, 1))
        if "npz" in formats:
            img.save(out / f"{path.stem}.npz")
        publish_stream_images(stream_callback, {"cropped": img}, logger=logger)
        publish_image_progress(
            progress_callback,
            step="cropping",
            image_path=str(path),
            image_index=index,
            image_total=len(ctx.image_paths),
            image_duration_s=time.monotonic() - t0,
        )
    publish_step_complete(
        progress_callback, step="cropping", step_elapsed_s=time.monotonic() - started
    )


def analysis_cropping(path, cls=None, all: bool = False, device=None, **kwargs) -> None:
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, all=all, device=device)
    analysis_cropping_from_context(ctx, **kwargs)
