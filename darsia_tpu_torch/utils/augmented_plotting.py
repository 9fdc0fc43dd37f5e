"""Plots that overlay analysis results on images.

Counterpart of :mod:`darsia_tpu.utils.augmented_plotting`: matplotlib is
imported when called and switched to its Agg backend, as in the JAX
package; figures are returned and optionally saved.  Masks, clipped
backgrounds and the statistics profiles are computed where the data lies;
only what is drawn is copied to the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..image.image import as_numpy
from .optional import agg_pyplot

__all__ = [
    "plot_contour_on_image",
    "plot_distribution_on_image",
    "plot_image_statistics",
]


def _data(image):
    return image.img if hasattr(image, "img") else image


def _background(ax, image):
    """Draw the image; a colour image clipped to [0, 1] before its copy."""
    data = _data(image)
    if isinstance(data, torch.Tensor):
        data = data.clamp(0, 1) if data.dim() == 3 else data
        ax.imshow(as_numpy(data))
    else:
        data = np.asarray(data)
        ax.imshow(np.clip(data, 0, 1) if data.ndim == 3 else data)


def _as_mpl_color(color):
    """Accept matplotlib color strings or RGB triples (0-1 or 0-255)."""
    if isinstance(color, str):
        return color
    rgb = np.asarray(color, dtype=float)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    return tuple(np.clip(rgb, 0, 1).tolist())


def plot_contour_on_image(
    image=None,
    mask=None,
    color="g",
    linewidth: float = 2.0,
    title: str = "",
    path: Optional[Path] = None,
    show: bool = False,
    *,
    img=None,
    alpha=None,
    thickness: Optional[float] = None,
    show_plot: Optional[bool] = None,
    return_image: bool = False,
):
    """Overlay mask contours on an image.

    Takes one mask or a list of masks with matching colour and alpha lists;
    ``return_image`` renders the figure and returns its RGB array.
    """
    plt = agg_pyplot("plot_contour_on_image")

    if img is not None:
        image = img
    if thickness is not None:
        linewidth = thickness
    if show_plot is not None:
        show = show_plot
    masks = mask if isinstance(mask, (list, tuple)) else [mask]
    is_single_rgb = (
        isinstance(color, (list, tuple))
        and len(color) in (3, 4)
        and all(isinstance(c, (int, float)) for c in color)
    )
    if isinstance(color, str) or is_single_rgb:
        colors = [color] * len(masks)
    else:
        colors = list(color)
    if alpha is None:
        alphas = [1.0] * len(masks)
    else:
        alphas = alpha if isinstance(alpha, (list, tuple)) else [alpha]
    fig, ax = plt.subplots()
    _background(ax, image)
    for m, c, a in zip(masks, colors, alphas):
        ax.contour(
            as_numpy(_data(m)).astype(float),
            levels=[0.5],
            colors=[_as_mpl_color(c)],
            linewidths=linewidth,
            alpha=float(np.clip(a, 0.05, 1.0)),
        )
    ax.set_title(title)
    ax.set_axis_off()
    if path is not None:
        fig.savefig(path, dpi=200, bbox_inches="tight")
    out = fig
    if return_image:
        fig.canvas.draw()
        rgba = np.asarray(fig.canvas.buffer_rgba())
        out = rgba[..., :3].copy()
    if not show:
        plt.close(fig)
    return out


def plot_distribution_on_image(
    image,
    distribution,
    alpha: float = 0.5,
    cmap: str = "viridis",
    title: str = "",
    path: Optional[Path] = None,
    show: bool = False,
):
    """Overlay a scalar field semi-transparently on an image."""
    plt = agg_pyplot("plot_distribution_on_image")

    fig, ax = plt.subplots()
    _background(ax, image)
    im = ax.imshow(as_numpy(_data(distribution)), alpha=alpha, cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_axis_off()
    if path is not None:
        fig.savefig(path, dpi=200, bbox_inches="tight")
    if not show:
        plt.close(fig)
    return fig


def _statistics(image, axis: int = 0) -> tuple:
    """(mean, std) host profiles of a scalar image (a colour image: of its
    channel mean) along ``axis``: rows for 0, columns for 1.  Reduced in
    float64 where the data lies; returned in the dtype numpy's reduction
    of the data has (float32 for float32 data, float64 for integers)."""
    data = _data(image)
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data))
    work = data.to(torch.float64)
    if work.dim() == 3:
        work = work.mean(dim=-1)
    mean = work.mean(dim=1 - axis)
    std = work.std(dim=1 - axis, correction=0)
    dtype = {torch.float32: np.float32, torch.float16: np.float16}.get(data.dtype, np.float64)
    return as_numpy(mean).astype(dtype), as_numpy(std).astype(dtype)


def plot_image_statistics(
    image,
    axis: int = 0,
    title: str = "",
    path: Optional[Path] = None,
    show: bool = False,
):
    """Plot per-row/column mean and std of a scalar image."""
    plt = agg_pyplot("plot_image_statistics")

    mean, std = _statistics(image, axis)
    fig, ax = plt.subplots()
    x = np.arange(mean.size)
    ax.plot(x, mean, label="mean")
    ax.fill_between(x, mean - std, mean + std, alpha=0.3, label="±std")
    ax.set_title(title)
    ax.legend()
    if path is not None:
        fig.savefig(path, dpi=200, bbox_inches="tight")
    if not show:
        plt.close(fig)
    return fig
