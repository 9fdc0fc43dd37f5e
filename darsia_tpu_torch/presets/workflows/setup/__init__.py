"""Setup workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.setup`; the imaging-protocol set-up,
which reads EXIF dates through PIL, is not ported yet: ROADMAP.md Queue 1
item 7c)."""

from .illustrations import save_discrete_map_illustration, save_scalar_map_illustration
from .setup_depth import setup_depth_map
from .setup_facies import setup_facies
from .setup_labeling import segment_colored_image
from .setup_rig import delete_rig, setup_rig

__all__ = [
    "delete_rig",
    "save_discrete_map_illustration",
    "save_scalar_map_illustration",
    "segment_colored_image",
    "setup_depth_map",
    "setup_facies",
    "setup_rig",
]
