"""Image-porosity analysis from baseline colours.

Counterpart of :mod:`darsia_tpu.presets.analysis.porosity`
(``PorosityAnalysis``, ``patched_porosity_analysis``).  The baseline's
gradient and its per-label means are float64 on the baseline's device; the
sample patches (drawn as the JAX package draws them, from
``np.random.default_rng(seed)``) go to the host for their k-means; the
porosity is the kernel interpolation of the clustered colours, evaluated
on the device.  A patch whose analysis fails warns and gets porosity 1, as
in the JAX package.

The JAX package draws one set of sample patches over the whole image and
uses it for every label, so a label that none of them touches has no
colours, and its image patch fails and is written as porosity 1 (ROADMAP.md
Queue 3, reference fault 25; a rig of 12 wavy layers at 4K has such a
label under any sampling cheap enough to run).  Here such a label gets its own patches, centred on seeded pixels
of the label; every label the shared patches touch is sampled as in the
JAX package.  ``samples_per_label`` keeps the patches each label used.
"""

from __future__ import annotations

import logging
from typing import Literal
from warnings import warn

import numpy as np
import torch

from ...image.arithmetics import zeros_like
from ...utils.box import random_patches
from ...utils.extractcharacteristicdata import extract_characteristic_data
from ...utils.masks import Masks
from .multichromatictracer import MultichromaticTracerAnalysis

logger = logging.getLogger(__name__)

__all__ = ["PorosityAnalysis", "patched_porosity_analysis"]


def _patches_on(mask: np.ndarray, width: int, num_patches: int, rng) -> list:
    """``num_patches`` square patches of ``width`` centred on seeded pixels
    of ``mask`` (shifted inside the image where they would leave it)."""
    pixels = np.flatnonzero(mask)
    picks = pixels[rng.integers(0, len(pixels), size=num_patches)]
    rows, cols = np.unravel_index(picks, mask.shape)
    patches = []
    for r, c in zip(rows.tolist(), cols.tolist()):
        r0 = min(max(r - width // 2, 0), max(mask.shape[0] - width, 0))
        c0 = min(max(c - width // 2, 0), max(mask.shape[1] - width, 0))
        patches.append((slice(r0, r0 + width), slice(c0, c0 + width)))
    return patches


def _gradient_modulus(base: torch.Tensor) -> torch.Tensor:
    """sqrt of the summed squared ``np.gradient`` of every channel along both
    axes (central differences inside, one-sided at the edges), float64."""
    total = torch.zeros(base.shape[:2], dtype=torch.float64, device=base.device)
    for i in range(base.shape[-1]):
        for axis in range(2):
            if base.shape[axis] > 1:
                total = total + torch.gradient(base[..., i], dim=axis)[0] ** 2
    return torch.sqrt(total)


class PorosityAnalysis(MultichromaticTracerAnalysis):
    """Map baseline colours to a porosity field per label.

    Colours near a label's dominant (sand) colours get porosity 1; colours
    far away (grains, residues) get porosity proportional to colour
    proximity.
    """

    def __init__(
        self,
        baseline,
        labels=None,
        mode: Literal["full", "random_samples", "custom"] = "random_samples",
        num_clusters: int = 5,
        num_attempts: int = 10,
        num_iterations: int = 100,
        eps: float = 1e-2,
        tol_color_distance: float = 0.1,
        tol_color_gradient: float = 0.02,
        debug: bool = False,
        **kwargs,
    ) -> None:
        if labels is None:
            labels = zeros_like(baseline, mode="voxels", dtype=np.uint8)
        super().__init__(
            baseline, labels=labels, relative=False, show_plot=False, use_tvd=False, **kwargs
        )

        base = torch.clamp(baseline.img.to(torch.float64), 0, 1)
        gradient = _gradient_modulus(base)

        colors, concentrations = [], []
        self.samples_per_label: dict = {}
        for mask, label in Masks(labels, return_label=True):
            mask_arr = mask.img.to(base.device)
            mask_size = max(int(mask_arr.sum()), 1)
            gradient_mask = float(gradient[mask_arr].sum()) / mask_size

            if mode == "full":
                samples = [(slice(0, None), slice(0, None))]
                warn("Full mode is time-consuming; consider random_samples.", RuntimeWarning)
            elif mode == "random_samples":
                width = int(kwargs.get("sample_width", 50))
                num_patches = int(kwargs.get("sample_num", 10))
                samples = random_patches(
                    tuple(mask_arr.shape),
                    width=width,
                    num_patches=num_patches,
                    rng=np.random.default_rng(kwargs.get("seed", 42)),
                )
                if not any(bool(mask_arr[sample].any()) for sample in samples):
                    samples = _patches_on(
                        mask_arr.cpu().numpy(),
                        width,
                        num_patches,
                        np.random.default_rng(kwargs.get("seed", 42)),
                    )
            elif mode == "custom":
                samples = kwargs.get("samples")
                if samples is None:
                    raise ValueError("custom mode requires explicit 'samples' boxes.")
            else:
                raise ValueError(f"Unknown porosity mode {mode!r}.")

            labels_collection, palette_collection = extract_characteristic_data(
                base,
                mask=mask_arr,
                samples=samples,
                num_clusters=num_clusters,
                num_attempts=num_attempts,
                num_iterations=num_iterations,
                eps=eps,
                mode="all",
                show_plot=debug,
            )

            self.samples_per_label[label.item() if hasattr(label, "item") else label] = samples
            colors_mask, concentrations_mask = [], []
            for cluster_labels, palette in zip(labels_collection, palette_collection):
                counts = np.bincount(np.asarray(cluster_labels).ravel(), minlength=len(palette))
                dominant = palette[int(np.argmax(counts))]
                for center in palette:
                    distance = float(np.linalg.norm(center - dominant))
                    # Dominant (sand) colours -> porosity 1; distant colours
                    # -> reduced porosity, harsher in low-gradient regions.
                    if distance < tol_color_distance or gradient_mask < tol_color_gradient:
                        value = 1.0
                    else:
                        value = float(np.clip(1.0 - distance / (2 * tol_color_distance), 0, 1))
                    colors_mask.append(center)
                    concentrations_mask.append(value)

            colors.append(np.vstack(colors_mask))
            concentrations.append(np.asarray(concentrations_mask))

        self.calibrate(colors, concentrations)

    def __call__(self, img):
        porosity = super().__call__(img)
        porosity.img = torch.clamp(porosity.img, 0, 1)
        return porosity

    def cut_off_small_values(self, porosity, threshold: float = 0.5):
        out = porosity.copy()
        arr = torch.clamp(out.img, 0, 1)
        out.img = torch.where(arr < threshold, torch.zeros_like(arr), arr)
        return out


def patched_porosity_analysis(
    baseline,
    patches: tuple = (1, 1),
    labels=None,
    mode: Literal["full", "random_samples", "custom"] = "random_samples",
    num_clusters: int = 5,
    num_attempts: int = 10,
    num_iterations: int = 100,
    eps: float = 1e-2,
    debug: bool = False,
    **kwargs,
):
    """Per-patch porosity analysis stitched into one image, on the
    baseline's device."""
    porosity = zeros_like(baseline, mode="voxels", dtype=np.float32)
    porosity_arr = porosity.img.clone()
    num_voxels = np.asarray(baseline.num_voxels[:2])
    patch_size = np.ceil(num_voxels / np.asarray(patches)).astype(int)
    if labels is None:
        labels = zeros_like(baseline, mode="voxels", dtype=np.uint8)
    for i in range(patches[0]):
        for j in range(patches[1]):
            subregion = (
                slice(i * patch_size[0], (i + 1) * patch_size[0]),
                slice(j * patch_size[1], (j + 1) * patch_size[1]),
            )
            sub_baseline = baseline.subregion(subregion)
            sub_labels = labels.subregion(subregion)
            if any(s == 0 for s in sub_baseline.img.shape[:2]):
                continue
            try:
                analysis = PorosityAnalysis(
                    baseline=sub_baseline,
                    labels=sub_labels,
                    mode=mode,
                    num_clusters=num_clusters,
                    num_attempts=num_attempts,
                    num_iterations=num_iterations,
                    eps=eps,
                    debug=debug,
                    **kwargs,
                )
                porosity_arr[subregion] = analysis(sub_baseline).img.to(porosity_arr.device)
            except Exception as e:
                warn(f"Porosity analysis failed for {subregion}: {e}")
                porosity_arr[subregion] = 1.0
    porosity.img = porosity_arr
    return porosity
