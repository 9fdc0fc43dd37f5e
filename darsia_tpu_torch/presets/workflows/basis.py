"""Label ids of a calibration or analysis basis.

Counterpart of :mod:`darsia_tpu.presets.workflows.basis`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["label_ids_from_image"]


def label_ids_from_image(labels_img) -> list:
    """Sorted non-negative label ids present in a labels image or array (a
    tensor is reduced on its device); negative ids mark masked-out voxels
    and are dropped."""
    arr = getattr(labels_img, "img", labels_img)
    ids = torch.unique(arr).tolist() if isinstance(arr, torch.Tensor) else np.unique(np.asarray(arr)).tolist()
    return [int(v) for v in ids if v >= 0]
