"""Protocol set-up: the imaging CSV from EXIF dates or file times, and the
injection and pressure/temperature templates.

Counterpart of :mod:`darsia_tpu.presets.workflows.setup.setup_protocols`.
The CSV is written with the ``csv`` module, cell for cell as the JAX
package's ``DataFrame.to_csv`` writes it.  EXIF dates are read through PIL
where it is installed; where it is not (the card's machine), and for files
without EXIF such as ``.npz`` photographs, the "exif" mode falls back to the
file's modification time, as the JAX package does on any failure.
"""

from __future__ import annotations

import logging
from datetime import datetime, timedelta
from pathlib import Path
from typing import Optional

from ....image.imread import _exif_date
from ....utils.csv_table import CsvTable
from ..config.fluidflower_config import FluidFlowerConfig

logger = logging.getLogger(__name__)

__all__ = [
    "get_modification_time",
    "preview_protocol_setup_conflicts",
    "setup_imaging_protocol",
]


def get_modification_time(filepath: Path) -> datetime:
    return datetime.fromtimestamp(Path(filepath).stat().st_mtime)


def _image_datetime(path: Path, mode: str) -> datetime:
    if mode == "exif":
        date = _exif_date(Path(path))
        if date is not None:
            return date
    return get_modification_time(path)


def _protocol_paths(config) -> dict:
    out = {}
    for name in ("imaging", "injection", "pressure_temperature"):
        spec = getattr(config.protocol, name)
        if spec is None:
            continue
        out[name] = Path(spec[0] if isinstance(spec, tuple) else spec)
    return out


def preview_protocol_setup_conflicts(path) -> list:
    """Existing protocol files that the set-up would overwrite."""
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("protocol", "data")
    return [p for p in _protocol_paths(config).values() if p.exists()]


def setup_imaging_protocol(
    path,
    mode: Optional[str] = None,
    overwrite: bool = False,
    write_templates: bool = True,
) -> Path:
    """Write the imaging protocol CSV (image_id, datetime, path) from EXIF
    dates (fallback: the file's modification time); optionally the injection
    and pressure/temperature templates."""
    config = FluidFlowerConfig(path, require_data=True, require_results=False)
    config.check("protocol", "data")
    paths = _protocol_paths(config)
    mode = mode or config.protocol.imaging_mode or "exif"

    imaging_path = paths["imaging"]
    if imaging_path.exists() and not overwrite:
        raise FileExistsError(f"Imaging protocol {imaging_path} exists; pass overwrite=True.")

    table = CsvTable()
    for image_id, file in enumerate(sorted(config.data.data)):
        table.append(
            {
                "image_id": image_id,
                "datetime": _image_datetime(file, mode).isoformat(),
                "path": Path(file).name,
            }
        )
    if not table.rows:
        raise FileNotFoundError("No images found for protocol setup.")
    imaging_path.parent.mkdir(parents=True, exist_ok=True)
    table.write(imaging_path)
    logger.info("Imaging protocol written to %s (%d images).", imaging_path, len(table.rows))

    if write_templates:
        start = datetime.fromisoformat(table.rows[0]["datetime"])
        end = datetime.fromisoformat(table.rows[-1]["datetime"])
        if "injection" in paths and (overwrite or not paths["injection"].exists()):
            paths["injection"].parent.mkdir(parents=True, exist_ok=True)
            paths["injection"].write_text(
                "location_x,location_y,start,end,rate_kg_s\n"
                f"0.0,0.0,{start.isoformat()},{end.isoformat()},0.0\n"
            )
        if "pressure_temperature" in paths and (
            overwrite or not paths["pressure_temperature"].exists()
        ):
            paths["pressure_temperature"].parent.mkdir(parents=True, exist_ok=True)
            paths["pressure_temperature"].write_text(
                "datetime,pressure,temperature\n"
                f"{start.isoformat()},1.013,23.0\n"
                f"{(end + timedelta(hours=1)).isoformat()},1.013,23.0\n"
            )
    return imaging_path
