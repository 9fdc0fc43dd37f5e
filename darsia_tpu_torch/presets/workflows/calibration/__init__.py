"""The calibration workflow steps (counterpart of
:mod:`darsia_tpu.presets.workflows.calibration`): the colour paths, the
colour-to-mass chain, their metadata and the legacy aliases."""

from .calibration_color_paths import (
    calibration_color_paths,
    calibration_color_paths_from_context,
    collect_existing_calibration_paths_to_delete,
    delete_calibration,
)
from .calibration_color_to_mass_analysis import (
    calibration_color_to_mass_analysis,
    calibration_color_to_mass_analysis_from_context,
)
from .legacy import (
    calibration_color_analysis,
    calibration_color_signal,
    calibration_flash,
    calibration_mass_analysis,
)
from .metadata import (
    read_calibration_metadata,
    validate_basis_metadata,
    write_calibration_metadata,
)

__all__ = [
    "calibration_color_analysis",
    "calibration_color_paths",
    "calibration_color_paths_from_context",
    "calibration_color_signal",
    "calibration_color_to_mass_analysis",
    "calibration_color_to_mass_analysis_from_context",
    "calibration_flash",
    "calibration_mass_analysis",
    "collect_existing_calibration_paths_to_delete",
    "delete_calibration",
    "read_calibration_metadata",
    "validate_basis_metadata",
    "write_calibration_metadata",
]
