"""Calibration bundles: a run's calibration folders copied out and in.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.calibration_bundle`
(byte copies of ``results/calibration/color/<embedding>``).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Optional

from ..config.fluidflower_config import FluidFlowerConfig

logger = logging.getLogger(__name__)

__all__ = [
    "export_calibration_bundle",
    "import_calibration_bundle",
    "preview_calibration_bundle_import_conflicts",
]


def _calibration_color_root(config) -> Path:
    assert config.data is not None
    return Path(config.data.results) / "calibration" / "color"


def _collect_bundle_targets(config) -> list:
    root = _calibration_color_root(config)
    if not root.exists():
        return []
    return sorted(p for p in root.iterdir() if p.is_dir())


def export_calibration_bundle(path, target: Optional[Path] = None) -> Path:
    """Copy the calibration/color tree into a portable bundle folder
    (``target`` or ``[utils] export_calibration_bundle``)."""
    config = FluidFlowerConfig(path, require_data=False, require_results=True)
    if target is None:
        assert (
            config.workflow_utils is not None
            and config.workflow_utils.export_calibration_bundle is not None
        ), "Provide target or [utils].export_calibration_bundle."
        target = config.workflow_utils.export_calibration_bundle
    target = Path(target)
    sources = _collect_bundle_targets(config)
    if not sources:
        raise FileNotFoundError("No calibration data found to export.")
    target.mkdir(parents=True, exist_ok=True)
    for source in sources:
        shutil.copytree(source, target / source.name, dirs_exist_ok=True)
    logger.info("Calibration bundle exported to %s.", target)
    return target


def preview_calibration_bundle_import_conflicts(path, bundle=None) -> list:
    """The calibration folders an import of ``bundle`` would overwrite."""
    config = FluidFlowerConfig(path, require_data=False, require_results=True)
    if bundle is None:
        assert config.workflow_utils is not None
        bundle = config.workflow_utils.import_calibration_bundle
    bundle = Path(bundle)
    root = _calibration_color_root(config)
    return [
        root / source.name
        for source in sorted(p for p in bundle.iterdir() if p.is_dir())
        if (root / source.name).exists()
    ]


def import_calibration_bundle(path, bundle=None, overwrite: bool = False) -> Path:
    """Copy a bundle's embeddings into this run's calibration tree (``bundle``
    or ``[utils] import_calibration_bundle``); refuses to overwrite unless
    ``overwrite``."""
    config = FluidFlowerConfig(path, require_data=False, require_results=True)
    if bundle is None:
        assert (
            config.workflow_utils is not None
            and config.workflow_utils.import_calibration_bundle is not None
        ), "Provide bundle or [utils].import_calibration_bundle."
        bundle = config.workflow_utils.import_calibration_bundle
    bundle = Path(bundle)
    conflicts = preview_calibration_bundle_import_conflicts(path, bundle)
    if conflicts and not overwrite:
        raise FileExistsError(f"Import would overwrite: {conflicts}. Pass overwrite=True.")
    root = _calibration_color_root(config)
    root.mkdir(parents=True, exist_ok=True)
    for source in sorted(p for p in bundle.iterdir() if p.is_dir()):
        shutil.copytree(source, root / source.name, dirs_exist_ok=True)
    logger.info("Calibration bundle imported into %s.", root)
    return root
