"""[utils] section (parity: reference
``presets/workflows/config/workflow_utils.py:9-40``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .toml_utils import get_section

__all__ = ["WorkflowUtilsConfig"]


@dataclass
class WorkflowUtilsConfig:
    export_calibration_bundle: Optional[Path] = None
    import_calibration_bundle: Optional[Path] = None

    def load(self, path) -> "WorkflowUtilsConfig":
        sec = get_section(path, "utils")
        if "export_calibration_bundle" in sec:
            self.export_calibration_bundle = Path(
                sec["export_calibration_bundle"]
            )
        if "import_calibration_bundle" in sec:
            self.import_calibration_bundle = Path(
                sec["import_calibration_bundle"]
            )
        return self
