"""Watershed segmentation of layered media, and label utilities.

Counterpart of :mod:`darsia_tpu.utils.segmentation`.  Segmentation runs once
per rig, at set-up.  The steps the JAX package runs on its device run here
on ``device`` (the CUDA card unless the caller names another): the gray
(rounded step by step as the JAX package's CPU program rounds it) or value
reduction, the split-Bregman smoothing, the rescaling
(``jax.image.resize``'s rules, :func:`~darsia_tpu_torch.ops.resize._resize_jax`)
and the Scharr stencils.  The contrast equalisation (numpy's ``argsort``, so
ties rank as there), the median filter, the markers, the watershed
(``scipy.ndimage.watershed_ift``) and the clean-up run on the host, as
there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ..image.image import Image, as_numpy, as_tensor
from ..ops.color import _GRAY_WEIGHTS, rgb_to_hsv
from ..ops.resize import _resize_jax
from .morphology import disk

__all__ = [
    "group_labels",
    "label_image",
    "make_consecutive",
    "reassign_labels",
    "scharr_edges",
    "segment",
]

# The Scharr stencil of the JAX package, for a true convolution.
_SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], dtype=np.float32) / 16.0


def _equalize(arr: np.ndarray) -> np.ndarray:
    """Log contrast, then global histogram equalisation (host)."""
    arr = arr.astype(np.float64)
    arr = arr - arr.min()
    arr = arr / max(arr.max(), 1e-12)
    arr = np.log1p(arr) / np.log(2.0)
    flat = arr.ravel()
    sorted_idx = np.argsort(flat)
    cdf = np.empty_like(flat)
    cdf[sorted_idx] = np.linspace(0, 1, flat.size)
    return cdf.reshape(arr.shape)


def _gray_rounded_per_step(rgb: torch.Tensor) -> torch.Tensor:
    """The luma of float32 RGB as the JAX package's CPU program computes it:
    ``fma(b, wb, fma(g, wg, r * wr))``, one float32 rounding per step (each
    product is exact in float64).  The equalisation ranks the pixels, so a
    last-bit difference of the gray swaps ranks; this order gives the same
    gray on every device."""
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=rgb.device).to(torch.float64)
    x = rgb.to(torch.float64)
    gray = (x[..., 0] * w[0]).to(torch.float32)
    for c in (1, 2):
        gray = (x[..., c] * w[c] + gray.to(torch.float64)).to(torch.float32)
    return gray


def _float32_on(array, device) -> torch.Tensor:
    """``array`` as float32 on ``device`` (a tensor stays where it is unless
    a device is given; numpy goes to the card by default), converted to
    float32 before it moves."""
    if isinstance(array, torch.Tensor):
        return as_tensor(array, device).to(torch.float32)
    return as_tensor(np.asarray(array, dtype=np.float32), device)


def scharr_edges(gray, device=None) -> np.ndarray:
    """Scharr gradient magnitude of a 2-D array, as ``convolve2d(..., "same")``
    (a true convolution, zero padding) computes it; numpy out."""
    g = _float32_on(gray, device)
    kx = torch.from_numpy(_SCHARR_X[::-1, ::-1].copy()).to(g.device)
    # conv2d correlates: the flipped stencils make it the convolution.
    weights = torch.stack([kx, kx.T.contiguous()])[:, None]
    grad = F.conv2d(g[None, None], weights, padding=1)[0]
    return as_numpy(torch.sqrt(grad[0] ** 2 + grad[1] ** 2))


def segment(
    img,
    markers_method: str = "gradient_based",
    edges_method: str = "gradient_based",
    mask: Optional[np.ndarray] = None,
    verbosity: bool = False,
    device=None,
    **kwargs,
):
    """Watershed segmentation workflow for layered media.

    Args:
        img: RGB or scalar image (array, tensor or Image).
        markers_method: "gradient_based" (markers from flat regions) or
            "supervised" (markers at the user's points in kwargs).
        edges_method: "gradient_based" or "scharr".
        mask: restrict the segmentation to a region.
        device: where the reduction, smoothing, rescaling and stencils run
            (default: the CUDA card).
        kwargs: "median disk radius", "rescaling factor",
            "monochromatic_color", "markers disk radius", "threshold",
            "region_size", "marker_points", "gradient disk radius",
            "cleanup", "dilation size", "boundary size", "boundary",
            "method" ("median" or "tvd"), "scharr mask".

    Returns:
        int32 labels from 0, as an Image (on the image's device) for an
        Image, else as a numpy array.

    """
    is_image = hasattr(img, "img")
    basis = as_numpy(img.img if is_image else img).astype(np.float64)
    if basis.max() > 1.5:
        basis = basis / 255.0

    if basis.ndim == 2:
        mono = basis
    else:
        monochromatic = kwargs.get("monochromatic_color", "gray")
        if monochromatic == "gray":
            mono = as_numpy(_gray_rounded_per_step(_float32_on(basis, device)))
        elif monochromatic in ("red", "green", "blue"):
            mono = basis[..., ("red", "green", "blue").index(monochromatic)]
        elif monochromatic == "value":
            mono = as_numpy(rgb_to_hsv(_float32_on(basis, device))[..., 2])
        else:
            raise ValueError(f"Monochromatic color {monochromatic} unsupported.")
    mono = _equalize(mono)

    smoothing_method = kwargs.get("method", "median")
    if smoothing_method == "median":
        radius = kwargs.get("median disk radius", 20)
        denoised = ndimage.median_filter(mono, footprint=disk(min(radius, 15)))
    elif smoothing_method == "tvd":
        from ..restoration.split_bregman_tvd import split_bregman_tvd

        denoised = as_numpy(
            split_bregman_tvd(_float32_on(mono, device), mu=0.1, max_num_iter=100)
        )
    else:
        raise ValueError(f"Smoothing method {smoothing_method} unsupported.")

    factor = kwargs.get("rescaling factor", 1.0)
    work = denoised
    if factor != 1.0:
        new_shape = (
            max(int(denoised.shape[0] * factor), 8),
            max(int(denoised.shape[1] * factor), 8),
        )
        work = as_numpy(_resize_jax(_float32_on(denoised, device), new_shape, "linear", True))

    if edges_method == "scharr":
        edges = scharr_edges(work, device)
        scharr_mask = kwargs.get("scharr mask")
        if scharr_mask is not None and scharr_mask.shape == edges.shape:
            edges = np.where(scharr_mask, edges, 0.0)
    else:
        radius = kwargs.get("gradient disk radius", 2)
        edges = ndimage.maximum_filter(scharr_edges(work, device), footprint=disk(radius))

    if markers_method == "supervised":
        markers = np.zeros(work.shape, dtype=np.int32)
        patch = kwargs.get("region_size", 1)
        pts = kwargs.get("marker_points")
        assert pts is not None, "Provide marker_points for supervised markers."
        for i, (r, c) in enumerate(np.asarray(pts, dtype=int)):
            markers[
                max(r - patch, 0) : r + patch + 1,
                max(c - patch, 0) : c + patch + 1,
            ] = i + 1
    else:
        threshold = kwargs.get("threshold")
        if threshold is None:
            threshold = np.quantile(edges, 0.3)
        flat = edges < threshold
        radius = kwargs.get("markers disk radius")
        if radius:
            flat = ndimage.binary_erosion(flat, structure=disk(radius))
        markers, _ = ndimage.label(flat)

    # The watershed on the uint16 edge landscape (host).
    landscape = (edges / max(edges.max(), 1e-12) * 65534).astype(np.uint16)
    labels = ndimage.watershed_ift(landscape, markers.astype(np.int32))
    labels = np.maximum(labels, 0)

    if factor != 1.0:
        labels = as_numpy(
            _resize_jax(_float32_on(labels, device), denoised.shape, "nearest", False)
        ).astype(np.int32)

    if mask is not None:
        labels = np.where(as_numpy(mask).astype(bool), labels, 0)

    if kwargs.get("cleanup", True):
        labels = _cleanup(labels, **kwargs)

    labels = _reset_labels(labels)

    if is_image:
        meta = img.metadata()
        meta["scalar"] = True
        return Image(torch.from_numpy(labels).to(img.device), **meta)
    return labels


def _cleanup(labels: np.ndarray, **kwargs) -> np.ndarray:
    """Fill holes, dilate, and copy the rows or columns next to the chosen
    sides over a boundary strip."""
    labels = _fill_holes(labels)
    dilation_size = kwargs.get("dilation size", 0)
    if dilation_size > 0:
        labels = ndimage.grey_dilation(labels, size=(dilation_size,) * 2)
    boundary_size = kwargs.get("boundary size", 0)
    if boundary_size > 0:
        for side in kwargs.get("boundary", ["top", "left", "bottom", "right"]):
            if side == "top":
                labels[:boundary_size] = labels[boundary_size : boundary_size + 1]
            elif side == "bottom":
                labels[-boundary_size:] = labels[-boundary_size - 1 : -boundary_size]
            elif side == "left":
                labels[:, :boundary_size] = labels[:, boundary_size : boundary_size + 1]
            elif side == "right":
                labels[:, -boundary_size:] = labels[:, -boundary_size - 1 : -boundary_size]
    return labels


def _fill_holes(labels: np.ndarray) -> np.ndarray:
    """Give each unlabelled pixel the label of its nearest labelled pixel."""
    unlabeled = labels == 0
    if not unlabeled.any():
        return labels
    _, (ir, ic) = ndimage.distance_transform_edt(unlabeled, return_indices=True)
    return labels[ir, ic]


def _reset_labels(labels: np.ndarray) -> np.ndarray:
    """Consecutive int32 labels from 0."""
    unique = np.unique(labels)
    mapping = np.zeros(unique.max() + 1, dtype=np.int32)
    mapping[unique] = np.arange(len(unique))
    return mapping[labels]


def _labels_like(labels, out: np.ndarray):
    """``out`` in the container of ``labels``: an Image's copy (the data on
    its device) or the numpy array."""
    if not hasattr(labels, "img"):
        return out
    result = labels.copy()
    result.img = torch.from_numpy(out).to(labels.img.device)
    return result


def label_image(img, map: Optional[dict] = None, significance: float = 0.0, **kwargs):
    """Label a coloured sketch: each distinct colour (quantised to 1/16)
    becomes a label; labels of less than ``significance`` of the pixels are
    merged into their neighbours."""
    is_image = hasattr(img, "img")
    data = as_numpy(img.img if is_image else img)
    if data.ndim == 2:
        labels = _reset_labels(data.astype(np.int32))
    else:
        flat = data.reshape(-1, data.shape[-1])
        quantized = np.round(flat.astype(np.float64) * 16) / 16
        _, inverse = np.unique(quantized, axis=0, return_inverse=True)
        labels = inverse.reshape(data.shape[:2]).astype(np.int32)
        if significance > 0:
            counts = np.bincount(labels.ravel())
            small = counts < significance * labels.size
            labels = np.where(small[labels], 0, labels)
            labels = _fill_holes(labels + 1) - 1 if small.any() else labels
        labels = _reset_labels(labels)
    if is_image:
        meta = img.metadata()
        meta["scalar"] = True
        return Image(torch.from_numpy(labels).to(img.device), **meta)
    return labels


def group_labels(labels, groups: list):
    """Merge groups of labels: each listed group becomes its first label,
    then the labels are made consecutive."""
    arr = as_numpy(labels.img if hasattr(labels, "img") else labels)
    out = arr.copy()
    for group in groups:
        target = group[0]
        for label in group[1:]:
            out[arr == label] = target
    return _labels_like(labels, _reset_labels(out))


def reassign_labels(labels, mapping: dict):
    """Apply an explicit old-label -> new-label mapping."""
    arr = as_numpy(labels.img if hasattr(labels, "img") else labels)
    out = arr.copy()
    for old, new in mapping.items():
        out[arr == old] = new
    return _labels_like(labels, out)


def make_consecutive(labels):
    """Renumber labels consecutively from 0."""
    arr = as_numpy(labels.img if hasattr(labels, "img") else labels)
    return _labels_like(labels, _reset_labels(arr.astype(np.int32)))
