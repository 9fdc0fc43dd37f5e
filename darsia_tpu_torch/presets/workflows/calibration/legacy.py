"""Legacy calibration entry points (the config schema before
``[calibration.*]``).

Counterpart of :mod:`darsia_tpu.presets.workflows.calibration.legacy`: each
warns (``DeprecationWarning``, naming the migration) and forwards onto the
current steps.
"""

from __future__ import annotations

from warnings import warn

from .calibration_color_paths import calibration_color_paths
from .calibration_color_to_mass_analysis import calibration_color_to_mass_analysis

__all__ = [
    "calibration_color_analysis",
    "calibration_color_signal",
    "calibration_flash",
    "calibration_mass_analysis",
]

_MIGRATION = (
    "uses the legacy config schema; move the settings into "
    "[calibration.color] / [calibration.mass] (see templates/config.toml)."
)


def _path_and_cls(cls, path):
    return (cls, None) if path is None else (path, cls)


def calibration_color_analysis(cls=None, path=None, show: bool = False, device=None):
    """Legacy alias of the colour-path calibration."""
    warn(f"calibration_color_analysis {_MIGRATION}", DeprecationWarning)
    path, cls = _path_and_cls(cls, path)
    return calibration_color_paths(path, cls=cls, show=show, device=device)


def calibration_color_signal(cls=None, path=None, show: bool = False, device=None):
    """Legacy alias: the signal functions are calibrated within the
    colour-to-mass step."""
    warn(f"calibration_color_signal {_MIGRATION}", DeprecationWarning)
    path, cls = _path_and_cls(cls, path)
    return calibration_color_to_mass_analysis(path, cls=cls, device=device)


def calibration_flash(cls=None, path=None, show: bool = False, device=None):
    """Legacy alias: the flash bounds are calibrated within the
    colour-to-mass step."""
    warn(f"calibration_flash {_MIGRATION}", DeprecationWarning)
    path, cls = _path_and_cls(cls, path)
    return calibration_color_to_mass_analysis(path, cls=cls, device=device)


def calibration_mass_analysis(cls=None, path=None, show: bool = False, device=None):
    """Legacy alias of the colour-to-mass calibration."""
    warn(f"calibration_mass_analysis {_MIGRATION}", DeprecationWarning)
    path, cls = _path_and_cls(cls, path)
    return calibration_color_to_mass_analysis(path, cls=cls, device=device)
