"""Iterate boolean masks over labelled images.

Counterpart of :mod:`darsia_tpu.utils.masks`.  A mask is computed where the
labels are: on their device for a tensor (or an Image holding one), on the
host for a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Masks"]


class Masks:
    """Iterator over per-label boolean masks of a labelled image."""

    def __init__(self, labels, return_label: bool = False) -> None:
        self.labels = labels
        data = labels.img if hasattr(labels, "img") else labels
        self._arr = data if isinstance(data, torch.Tensor) else np.asarray(data)
        if isinstance(self._arr, torch.Tensor):
            self.unique_labels = torch.unique(self._arr).cpu().numpy()
        else:
            self.unique_labels = np.unique(self._arr)
        self.return_label = return_label
        self._idx = 0

    @property
    def size(self) -> int:
        return len(self.unique_labels)

    def _make(self, label):
        mask = self._arr == (label.item() if isinstance(self._arr, torch.Tensor) else label)
        if hasattr(self.labels, "metadata"):
            from ..image.image import Image

            meta = self.labels.metadata()
            meta["scalar"] = True
            out = Image(mask, **meta)
        else:
            out = mask
        if self.return_label:
            return out, label
        return out

    def __iter__(self):
        self._idx = 0
        return self

    def __next__(self):
        if self._idx >= self.size:
            raise StopIteration
        result = self._make(self.unique_labels[self._idx])
        self._idx += 1
        return result

    def __getitem__(self, key):
        return self._make(self.unique_labels[key])
