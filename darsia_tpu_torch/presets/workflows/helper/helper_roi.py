"""ROI helper: define and inspect ROIs on the baseline.

Counterpart of :mod:`darsia_tpu.presets.workflows.helper.helper_roi`.
:func:`helper_roi` with two points and :func:`format_roi_template` are
headless; without points the corners are picked by hand with
:class:`~darsia_tpu_torch.assistants.SubregionAssistant`, and the viewers
need matplotlib.
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ....image.image import as_numpy
from ....utils.optional import optional_module
from ..utils.roi_visualization import build_active_mask_from_rois, draw_active_region

logger = logging.getLogger(__name__)

__all__ = [
    "helper_roi_viewer",
    "helper_roi",
    "format_roi_template",
    "launch_roi_helper_viewer",
    "launch_roi_viewer",
]


def _pyplot(what: str):
    return optional_module("matplotlib", what), optional_module("matplotlib.pyplot", what)


def format_roi_template(corner_1, corner_2) -> str:
    """TOML snippet for a freshly picked ROI."""
    return (
        "[roi.roi_name]\n"
        'name = "roi_name"\n'
        f"corner_1 = [{float(corner_1[0]):.8g}, {float(corner_1[1]):.8g}]\n"
        f"corner_2 = [{float(corner_2[0]):.8g}, {float(corner_2[1]):.8g}]\n"
    )


def _stepper(images: list, render, title: str):  # pragma: no cover - interactive
    """A figure stepping through ``images`` with Prev/Next buttons."""
    _, plt = _pyplot(title)
    widgets = importlib.import_module("matplotlib.widgets")
    if len(images) == 0:
        raise ValueError(f"{title} received no images.")
    fig, ax = plt.subplots(figsize=(11, 8))
    plt.subplots_adjust(bottom=0.16)
    state = {"idx": 0}

    def _render() -> None:
        ax.cla()
        render(ax, state["idx"])
        fig.canvas.draw_idle()

    def _step(delta: int):
        def _go(_event) -> None:
            state["idx"] = (state["idx"] + delta) % len(images)
            _render()

        return _go

    prev_btn = widgets.Button(fig.add_axes([0.3, 0.04, 0.1, 0.06]), "Prev")
    next_btn = widgets.Button(fig.add_axes([0.6, 0.04, 0.1, 0.06]), "Next")
    prev_btn.on_clicked(_step(-1))
    next_btn.on_clicked(_step(1))
    _render()
    return plt, ax, state, (prev_btn, next_btn)


def launch_roi_helper_viewer(
    images: list, *, mode: str, title_prefix: str = "ROI helper"
) -> None:  # pragma: no cover - interactive
    """Frame stepper with a rectangle selector that prints the ROI TOML
    snippet of the selected box (needs matplotlib and a display)."""

    def render(ax, idx: int) -> None:
        data = as_numpy(getattr(images[idx], "img", images[idx]))
        ax.imshow(np.clip(data, 0, 1) if data.ndim == 3 else data)
        ax.set_title(f"{title_prefix} [{mode}] {idx + 1}/{len(images)}")

    plt, ax, state, _buttons = _stepper(images, render, "The ROI helper")
    widgets = importlib.import_module("matplotlib.widgets")

    def _on_select(eclick, erelease) -> None:
        img = images[state["idx"]]
        if hasattr(img, "coordinatesystem"):
            c1 = img.coordinatesystem.coordinate([int(eclick.ydata), int(eclick.xdata)])
            c2 = img.coordinatesystem.coordinate([int(erelease.ydata), int(erelease.xdata)])
        else:
            c1, c2 = (eclick.xdata, eclick.ydata), (erelease.xdata, erelease.ydata)
        print(format_roi_template(np.asarray(c1), np.asarray(c2)))

    selector = widgets.RectangleSelector(ax, _on_select, useblit=True, interactive=True)
    plt.show()
    del selector


def launch_roi_viewer(images: list, *, roi_entries: dict, title_prefix: str) -> None:  # pragma: no cover
    """Frame stepper drawing the registered ROIs over each image (needs
    matplotlib and a display)."""
    if len(images) == 0:
        raise ValueError("ROI Viewer received no images.")
    mask = build_active_mask_from_rois(roi_entries, images[0])

    def render(ax, idx: int) -> None:
        draw_active_region(ax, images[idx], mask, title=f"{title_prefix} {idx + 1}/{len(images)}")

    plt, _, _, _buttons = _stepper(images, render, "The ROI viewer")
    plt.show()


def helper_roi_viewer(path, cls=None, keys: Optional[list] = None, device=None) -> Path:
    """Draw all (or the selected) registered ROIs over the baseline into
    ``results/helper/roi_overview.png`` (needs matplotlib, and OpenCV for
    the outline)."""
    from ..analysis.analysis_context import prepare_analysis_context
    from ..rig import Rig

    matplotlib, plt = _pyplot("The ROI overview")
    matplotlib.use("Agg")
    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="helper", device=device)
    registry = ctx.config.roi_registry
    assert registry is not None, "No [roi.*] entries configured."
    selected = registry.resolve(keys or registry.keys())
    mask = build_active_mask_from_rois(selected, ctx.fluidflower.baseline)
    out = Path(ctx.config.data.results) / "helper" / "roi_overview.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    draw_active_region(ax, ctx.fluidflower.baseline, mask, title="Registered ROIs")
    fig.savefig(out, dpi=200, bbox_inches="tight")
    plt.close(fig)
    logger.info("ROI overview written to %s.", out)
    return out


def helper_roi(path, cls=None, points: Optional[list] = None, device=None) -> dict:
    """A new ROI from two voxel points on the baseline: prints its TOML
    snippet and returns its corners.  Without points the corners are picked
    by hand (:class:`~darsia_tpu_torch.assistants.SubregionAssistant`:
    matplotlib and a display)."""
    from ....assistants.selection_assistants import SubregionAssistant
    from ..analysis.analysis_context import prepare_analysis_context
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="helper", device=device)
    baseline = ctx.fluidflower.baseline
    if points is not None:
        coords = np.asarray([np.asarray(baseline.coordinatesystem.coordinate(p)) for p in points])
    else:
        coords = SubregionAssistant(baseline)()
    snippet = (
        "[roi.new_roi]\n"
        'name = "new_roi"\n'
        f"corner_1 = [{coords[0][0]:.4f}, {coords[0][1]:.4f}]\n"
        f"corner_2 = [{coords[1][0]:.4f}, {coords[1][1]:.4f}]\n"
    )
    print(snippet)
    return {"corner_1": coords[0].tolist(), "corner_2": coords[1].tolist()}
