"""Characteristic-color extraction from image samples (k-means based).

Counterpart of :mod:`darsia_tpu.utils.extractcharacteristicdata`.  The
signal may be a tensor on any device (or an Image holding one): only the
sample patches are copied to the host, where the k-means of
:mod:`darsia_tpu_torch.utils.kmeans` clusters them, as the JAX package does
with the whole array.  Like the JAX function, ``filter`` is accepted and not
applied.
"""

from __future__ import annotations

from typing import Literal, Optional
from warnings import warn

import numpy as np
import torch

from .kmeans import kmeans

__all__ = ["extract_characteristic_data"]


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    return np.asarray(data)


def extract_characteristic_data(
    signal,
    mask=None,
    samples: Optional[list[tuple]] = None,
    filter: callable = lambda x: x,
    num_clusters: int = 5,
    num_attempts: int = 100,
    num_iterations: int = 200,
    eps: float = 1e-1,
    mode: Literal["most_common", "least_common", "all"] = "most_common",
    show_plot: bool = False,
):
    """Representative colors of image patches, by clustering.

    Args:
        signal: 2-D (optionally multichannel) image, tensor or array.
        mask: boolean mask restricting eligible pixels.
        samples: list of 2-D slice tuples; the full image if None.
        filter: preprocessing callable; accepted, not applied (as in the
            JAX package).
        num_clusters: clusters per sample.
        mode: return the most-common / least-common cluster center, or all.

    Returns:
        (num_samples, data_dim) array of characteristic colors, or
        (labels, palettes) when mode == "all".

    """
    if samples is None:
        samples = [(slice(0, None), slice(0, None))]
    data = signal.img if hasattr(signal, "img") else signal
    mask_arr = None
    if mask is not None:
        mask_arr = _host(mask.img if hasattr(mask, "img") else mask).astype(bool)

    channels = data.shape[-1] if len(data.shape) >= 3 else 1
    data_dim = channels
    if data_dim not in (1, 3):
        data_dim = 1
        warn("Implicitly assume that the data is scalar.")

    clusters = []
    labels_collection = []
    palette_collection = []
    for sample in samples:
        patch = _host(data[sample])
        pixels = patch.reshape(-1, channels)[:, :data_dim]
        if mask_arr is not None:
            pixels = pixels[mask_arr[sample].reshape(-1)]
        if pixels.shape[0] == 0:
            continue
        labels, palette = kmeans(pixels.astype(np.float64), num_clusters, num_iter=num_iterations)
        _, counts = np.unique(labels, return_counts=True)
        labels_collection.append(labels)
        palette_collection.append(palette)
        if mode == "most_common":
            clusters.append(palette[np.argmax(counts)])
        elif mode == "least_common":
            clusters.append(palette[np.argmin(counts)])

    if mode == "all":
        return labels_collection, palette_collection
    return np.array(clusters)
