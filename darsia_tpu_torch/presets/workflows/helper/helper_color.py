"""Colour explorer: colour statistics of image regions.

Counterpart of :mod:`darsia_tpu.presets.workflows.helper.helper_color`.
:func:`color_report` converts on the image's device (``ops/color.py``) and
reads every statistic back in one host read.  The histogram picture is drawn
with matplotlib where it imports; otherwise a warning is given once and
nothing is drawn.
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Optional
from warnings import warn

import torch

from ....image.image import as_numpy, as_tensor
from ....ops.color import convert_trichromatic

logger = logging.getLogger(__name__)

__all__ = ["color_report", "launch_color_helper", "helper_color"]

_SPACES = ("RGB", "HSV", "LAB")
_STATISTICS = ("mean", "std", "min", "max")
_warned = False


def _unit_colors(image) -> torch.Tensor:
    """The image's colours in [0, 1] (float64; 8-bit values scaled)."""
    data = as_tensor(image.img if hasattr(image, "img") else image).to(torch.float64)
    return data / torch.where(data.max() > 1.5, 255.0, 1.0)


def color_report(image, box: Optional[tuple] = None) -> dict:
    """Per channel mean, std, min and max of a region in RGB, HSV and LAB."""
    data = _unit_colors(image)
    if box is not None:
        data = data[box]
    rows = []
    for space in _SPACES:
        converted = convert_trichromatic(data.to(torch.float32), "RGB", space).reshape(-1, 3)
        rows += [
            converted.mean(dim=0),
            converted.std(dim=0, correction=0),
            converted.amin(dim=0),
            converted.amax(dim=0),
        ]
    values = as_numpy(torch.stack(rows)).reshape(len(_SPACES), len(_STATISTICS), 3)
    return {
        space: {stat: values[i, j].tolist() for j, stat in enumerate(_STATISTICS)}
        for i, space in enumerate(_SPACES)
    }


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (warned once)."""
    global _warned
    try:
        matplotlib = importlib.import_module("matplotlib")
    except ImportError:
        if not _warned:
            warn("matplotlib is not installed: the colour histograms are not drawn")
            _warned = True
        return None
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def launch_color_helper(image, boxes: Optional[list] = None, path: Optional[Path] = None) -> list:
    """Colour reports for the given boxes (None: the whole image); with
    ``path`` the channel histograms are drawn there."""
    reports = [color_report(image, box) for box in (boxes or [None])]
    for i, report in enumerate(reports):
        logger.info("box %d RGB mean: %s", i, report["RGB"]["mean"])
    plt = _pyplot() if path is not None else None
    if plt is not None:
        data = as_numpy(_unit_colors(image))
        fig, axes = plt.subplots(1, 3, figsize=(12, 3))
        for c, (ax, name) in enumerate(zip(axes, "RGB")):
            ax.hist(data[..., c].ravel(), bins=64, color=name.lower())
            ax.set_title(name)
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return reports


def helper_color(path, cls=None, boxes: Optional[list] = None, device=None) -> list:
    """Colour reports of the corrected baseline on ``device`` (None: the
    CUDA card); the histograms go to ``results/helper``."""
    from ..analysis.analysis_context import prepare_analysis_context
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="helper", device=device)
    out = Path(ctx.config.data.results) / "helper" / "color_histograms.png"
    return launch_color_helper(ctx.fluidflower.baseline, boxes=boxes, path=out)
