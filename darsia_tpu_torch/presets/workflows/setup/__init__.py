"""Setup workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.setup`)."""

from .illustrations import save_discrete_map_illustration, save_scalar_map_illustration
from .setup_depth import setup_depth_map
from .setup_facies import setup_facies
from .setup_labeling import segment_colored_image
from .setup_protocols import (
    get_modification_time,
    preview_protocol_setup_conflicts,
    setup_imaging_protocol,
)
from .setup_rig import delete_rig, setup_rig

__all__ = [
    "delete_rig",
    "get_modification_time",
    "preview_protocol_setup_conflicts",
    "save_discrete_map_illustration",
    "save_scalar_map_illustration",
    "segment_colored_image",
    "setup_depth_map",
    "setup_facies",
    "setup_imaging_protocol",
    "setup_rig",
]
