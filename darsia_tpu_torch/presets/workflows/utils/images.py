"""Corrected-image loading with an npz cache.

Counterpart of :mod:`darsia_tpu.presets.workflows.utils.images`.  A cached
image is read back on the rig's device without touching the corrections.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ....image.imread import imread

__all__ = ["load_images_with_cache"]


def load_images_with_cache(
    rig, paths: list, use_cache: bool = False, cache_dir: Optional[Path] = None
) -> list:
    """Read and correct images through ``rig``; with ``use_cache`` each
    corrected image is saved as npz in ``cache_dir`` and read from there the
    next time."""
    images = []
    for path in paths:
        path = Path(path)
        if use_cache and cache_dir is not None:
            cache_path = Path(cache_dir) / path.with_suffix(".npz").name
            if cache_path.exists():
                images.append(imread(cache_path, device=rig.device))
                continue
            image = rig.read_image(path)
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            image.save(cache_path)
            images.append(image)
        else:
            images.append(rig.read_image(path))
    return images
