"""Data transfer planning: a local copy of the source ``[download]`` names.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.utils_download`.
Only local sources are copied; nothing is fetched over a network.
"""

from __future__ import annotations

import logging
import shutil
from dataclasses import dataclass, field
from pathlib import Path

from ..config.fluidflower_config import FluidFlowerConfig

logger = logging.getLogger(__name__)

__all__ = ["DownloadPlan", "prepare_download_data", "download_data"]


def _format_size(total_size: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if total_size < 1024:
            return f"{total_size:.1f} {unit}"
        total_size /= 1024
    return f"{total_size:.1f} PB"


@dataclass
class DownloadPlan:
    source: Path
    target: Path
    items: list = field(default_factory=list)
    skip_existing: bool = True

    @property
    def total_size(self) -> int:
        return sum(size for _, size in self.items)

    def describe(self) -> str:
        return (
            f"{len(self.items)} files ({_format_size(self.total_size)}) "
            f"from {self.source} -> {self.target}"
        )


def prepare_download_data(path) -> DownloadPlan:
    """Plan the transfer ``[download]`` describes: every file under the
    source not yet in the target (with ``skip_existing``)."""
    config = FluidFlowerConfig(path, require_data=False, require_results=False)
    config.check("download")
    source = Path(config.download.source)
    target = Path(config.download.folder or (config.data.folder if config.data else "data"))
    items = []
    if source.exists():
        for file in sorted(source.rglob("*")):
            if not file.is_file():
                continue
            if config.download.skip_existing and (target / file.relative_to(source)).exists():
                continue
            items.append((file, file.stat().st_size))
    return DownloadPlan(
        source=source, target=target, items=items, skip_existing=config.download.skip_existing
    )


def download_data(path, dry_run: bool = False) -> DownloadPlan:
    """Carry out the plan (a local copy); a source that is not a local
    folder raises."""
    plan = prepare_download_data(path)
    logger.info("Download plan: %s", plan.describe())
    if dry_run:
        return plan
    if not plan.source.exists():
        raise FileNotFoundError(
            f"Source {plan.source} not reachable (remote sources require network access)."
        )
    for file, _ in plan.items:
        destination = plan.target / file.relative_to(plan.source)
        destination.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(file, destination)
    logger.info("Copied %d files.", len(plan.items))
    return plan
