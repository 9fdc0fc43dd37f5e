"""Depth-map setup from CSV measurements.

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.setup_depth`; the
map is interpolated onto the rig's resolution on ``device`` (None: the
card) and saved as ``.npz``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ....image.image import Image
from ....utils.interpolation import interpolate_to_image_from_csv
from ..config.fluidflower_config import FluidFlowerConfig
from .illustrations import save_scalar_map_illustration

logger = logging.getLogger(__name__)

__all__ = ["setup_depth_map"]


def setup_depth_map(path, key: str = "mean", show: bool = False, device=None) -> None:
    """Interpolate CSV depth measurements onto the rig resolution and save."""
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("depth", "rig")
    proxy = Image(
        np.zeros(tuple(int(v) for v in config.rig.resolution)),
        width=config.rig.width,
        height=config.rig.height,
        scalar=True,
        device=device,
    )
    depth_map = interpolate_to_image_from_csv(
        csv_file=config.depth.measurements, key=key, image=proxy, method="rbf"
    )
    depth_map_path = Path(config.depth.depth_map).with_suffix(".npz")
    depth_map_path.parent.mkdir(parents=True, exist_ok=True)
    depth_map.save(depth_map_path)
    save_scalar_map_illustration(
        depth_map.img,
        Path(config.depth.depth_map).with_suffix(".jpg"),
        title="Depth map",
        colorbar_label="Depth",
    )
    logger.info("Depth map saved to %s.", depth_map_path)
