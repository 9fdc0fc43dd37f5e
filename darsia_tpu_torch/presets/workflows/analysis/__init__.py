"""Workflow analysis steps (counterpart of
:mod:`darsia_tpu.presets.workflows.analysis`).

The context, the mass, volume, cropping, segmentation, finger and
thresholding steps and their helpers.  The segmentation and thresholding
steps only draw figures, with matplotlib: where it does not import they
raise, naming it, before they read a photograph.
"""

from .analysis_context import (
    AnalysisContext,
    build_restoration,
    infer_require_color_to_mass_from_config,
    iter_prefetched_images,
    prepare_analysis_context,
    select_image_paths,
)
from .analysis_cropping import analysis_cropping, analysis_cropping_from_context
from .analysis_fingers import analysis_fingers, analysis_fingers_from_context
from .analysis_mass import analysis_mass_from_context, run_mass_analysis
from .analysis_segmentation import analysis_segmentation, analysis_segmentation_from_context
from .analysis_thresholding import analysis_thresholding, analysis_thresholding_from_context
from .analysis_volume import analysis_volume, analysis_volume_from_context
from .expert_knowledge import ExpertKnowledgeAdapter
from .image_export_formats import ImageExportFormats
from .progress import (
    AnalysisProgressEvent,
    normalize_progress_event,
    publish_analysis_progress,
    publish_image_progress,
    publish_step_complete,
    publish_step_start,
)
from .scalar_products import (
    RescaledMassProducts,
    analysis_scalar_products,
    compute_rescaled_mass_products,
    requires_rescaled_modes,
)
from .streaming import encode_low_resolution_png, publish_preview, publish_stream_images

__all__ = [
    "AnalysisContext",
    "AnalysisProgressEvent",
    "ExpertKnowledgeAdapter",
    "ImageExportFormats",
    "RescaledMassProducts",
    "analysis_cropping",
    "analysis_cropping_from_context",
    "analysis_fingers",
    "analysis_fingers_from_context",
    "analysis_mass_from_context",
    "analysis_scalar_products",
    "analysis_segmentation",
    "analysis_segmentation_from_context",
    "analysis_thresholding",
    "analysis_thresholding_from_context",
    "analysis_volume",
    "analysis_volume_from_context",
    "build_restoration",
    "compute_rescaled_mass_products",
    "encode_low_resolution_png",
    "infer_require_color_to_mass_from_config",
    "iter_prefetched_images",
    "normalize_progress_event",
    "prepare_analysis_context",
    "publish_analysis_progress",
    "publish_image_progress",
    "publish_preview",
    "publish_step_complete",
    "publish_step_start",
    "publish_stream_images",
    "requires_rescaled_modes",
    "run_mass_analysis",
    "select_image_paths",
]

