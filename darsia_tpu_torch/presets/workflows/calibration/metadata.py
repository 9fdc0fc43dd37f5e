"""Calibration metadata: which colour basis a calibration folder was made
with.

Counterpart of :mod:`darsia_tpu.presets.workflows.calibration.metadata`
(the same ``calibration_metadata.json``).
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from ....signals.color import parse_color_embedding_basis

__all__ = [
    "write_calibration_metadata",
    "read_calibration_metadata",
    "validate_basis_metadata",
]

_METADATA_NAME = "calibration_metadata.json"


def write_calibration_metadata(folder: Path, basis, extra: Optional[dict] = None) -> dict:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    payload = {
        "basis": parse_color_embedding_basis(basis).value,
        "created": datetime.now(timezone.utc).isoformat(),
    }
    if extra:
        payload.update(extra)
    (folder / _METADATA_NAME).write_text(json.dumps(payload, indent=2))
    return payload


def read_calibration_metadata(path: Path) -> Optional[dict]:
    file = Path(path) / _METADATA_NAME
    if not file.exists():
        return None
    return json.loads(file.read_text())


def validate_basis_metadata(folder: Path, expected_basis) -> None:
    """Raise when the folder was calibrated in another basis (a folder
    without metadata passes)."""
    metadata = read_calibration_metadata(folder)
    expected = parse_color_embedding_basis(expected_basis).value
    if metadata is None:
        return
    stored = metadata.get("basis")
    if stored is not None and stored != expected:
        raise ValueError(
            f"Calibration at {folder} was created with basis {stored!r}, "
            f"but {expected!r} was requested."
        )
