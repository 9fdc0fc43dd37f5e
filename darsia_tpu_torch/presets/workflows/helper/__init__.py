"""The helper workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.helper`): the colour report, the result
reader and re-export, and the ROI helper."""

from .helper_color import color_report, helper_color, launch_color_helper
from .helper_result_reader import ResultFrame, helper_results, load_result_frames
from .helper_roi import format_roi_template, helper_roi, helper_roi_viewer

__all__ = [
    "ResultFrame",
    "color_report",
    "format_roi_template",
    "helper_color",
    "helper_results",
    "helper_roi",
    "helper_roi_viewer",
    "launch_color_helper",
    "load_result_frames",
]
