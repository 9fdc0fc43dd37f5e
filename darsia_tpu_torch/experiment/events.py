"""Event helpers: match available images to requested datetimes.

Counterpart of :mod:`darsia_tpu.experiment.events` (reference
``experiment/events.py``).
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["find_images_for_datetimes"]


def find_images_for_datetimes(
    folder: Path, imaging_protocol, datetimes: list
) -> list:
    """Closest available image per requested datetime."""
    folder = Path(folder)
    available = [p for p in sorted(folder.glob("*")) if p.is_file()]
    dated = []
    for path in available:
        try:
            date = imaging_protocol.get_datetime(path)
        except (ValueError, KeyError):
            continue
        if date is not None:
            dated.append((date, path))
    if not dated:
        raise ValueError(f"No protocolled images found in {folder}.")
    out = []
    for dt in datetimes:
        closest = min(dated, key=lambda item: abs((item[0] - dt).total_seconds()))
        out.append(closest[1])
    return out
