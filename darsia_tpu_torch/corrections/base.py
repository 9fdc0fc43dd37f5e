"""Correction protocol: array transforms plus metadata bookkeeping.

Counterpart of :mod:`darsia_tpu.corrections.base` for single images.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BaseCorrection"]


class BaseCorrection:
    """Base correction: an array transform applied to an Image or a tensor."""

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        """Transform a single space(+range) tensor. Override."""
        raise NotImplementedError

    def correct_metadata(self, metadata: Optional[dict] = None) -> dict:
        """Metadata updates induced by the correction. Override if needed."""
        return {}

    def __call__(self, image, overwrite: bool = False):
        """Apply the correction to an Image (or a raw tensor).

        Args:
            image: Image or tensor.
            overwrite: update the image in place (the constructor's
                transformation chain); otherwise return a corrected copy.

        """
        if isinstance(image, torch.Tensor):
            return self.correct_array(image)
        corrected = self.correct_array(image.img)
        meta_update = self.correct_metadata(image.metadata())
        if overwrite:
            image.img = corrected
            for key, value in meta_update.items():
                setattr(image, key, value)
            return image
        metadata = image.metadata()
        metadata.update(meta_update)
        return type(image)(img=corrected, **metadata)
