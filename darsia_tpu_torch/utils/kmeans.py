"""Deterministic k-means (host-side setup utility).

Counterpart of :mod:`darsia_tpu.utils.kmeans`, a numpy copy: the same
seeded k-means++ initialisation and Lloyd iterations, so the same data give
the same clusters bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dominant_color", "kmeans"]


def kmeans(
    data: np.ndarray,
    num_clusters: int,
    num_iter: int = 50,
    seed: int = 0,
    tol: float = 1e-6,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means with k-means++ initialisation.

    Args:
        data: (N, D) samples.
        num_clusters: number of clusters.
        num_iter: max iterations.
        seed: RNG seed.
        tol: early-exit tolerance on the center movement.

    Returns:
        (labels (N,), centers (K, D)).

    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    k = min(num_clusters, n)
    rng = np.random.default_rng(seed)

    # k-means++ seeding.
    centers = np.empty((k, data.shape[1]))
    centers[0] = data[rng.integers(n)]
    closest_sq = np.sum((data - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = closest_sq.sum()
        if total <= 0:
            centers[i:] = data[rng.integers(n, size=k - i)]
            break
        centers[i] = data[rng.choice(n, p=closest_sq / total)]
        closest_sq = np.minimum(closest_sq, np.sum((data - centers[i]) ** 2, axis=1))

    labels = np.zeros(n, dtype=int)
    for _ in range(num_iter):
        dists = ((data[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        labels = np.argmin(dists, axis=1)
        new_centers = np.array(
            [
                data[labels == j].mean(axis=0) if np.any(labels == j) else centers[j]
                for j in range(k)
            ]
        )
        move = np.abs(new_centers - centers).max()
        centers = new_centers
        if move < tol:
            break
    return labels, centers


def dominant_color(pixels: np.ndarray, num_clusters: int = 5, seed: int = 0) -> np.ndarray:
    """Dominant color of a pixel cloud: the center of the most populous cluster."""
    labels, centers = kmeans(pixels.reshape(-1, pixels.shape[-1]), num_clusters, seed=seed)
    _, counts = np.unique(labels, return_counts=True)
    return centers[np.argmax(counts)]
