"""Workflow utilities (counterpart of :mod:`darsia_tpu.presets.workflows.utils`):
the comparison's mass-map loader, the cached image loader, calibration
bundles, the data-transfer plan, media outputs (OpenCV) and the ROI
rendering."""

from .calibration_bundle import (
    export_calibration_bundle,
    import_calibration_bundle,
    preview_calibration_bundle_import_conflicts,
)
from .images import load_images_with_cache
from .mass import load_data
from .roi_visualization import (
    ActiveRegionRenderData,
    build_active_mask_from_rois,
    draw_active_region,
    render_active_region,
)
from .utils_download import DownloadPlan, download_data, prepare_download_data
from .utils_media import build_media

__all__ = [
    "ActiveRegionRenderData",
    "DownloadPlan",
    "build_active_mask_from_rois",
    "build_media",
    "download_data",
    "draw_active_region",
    "export_calibration_bundle",
    "import_calibration_bundle",
    "load_data",
    "load_images_with_cache",
    "prepare_download_data",
    "preview_calibration_bundle_import_conflicts",
    "render_active_region",
]
