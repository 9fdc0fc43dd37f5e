"""Result reader: saved analysis fields loaded and re-exported.

Counterpart of :mod:`darsia_tpu.presets.workflows.helper.helper_result_reader`.
The summary statistics of a field are its host values' (the integral summed
in numpy's order, as ``Geometry.integrate`` sums host data), so they equal
the JAX package's.  Re-exports as npz and csv are headless; jpg and png, and
the interactive viewer, need matplotlib.
"""

from __future__ import annotations

import importlib
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ....image.image import as_numpy
from ....image.imread import imread
from ....utils.optional import optional_module
from ..analysis.analysis_context import prepare_analysis_context
from ..mode_resolution import SCALAR_PRODUCT_MODES

logger = logging.getLogger(__name__)

__all__ = [
    "ResultFrame",
    "helper_results",
    "load_result_frames",
    "launch_result_reader",
    "helper_result_reader",
]


@dataclass
class ResultFrame:
    """One loaded result field with its provenance and summary statistics."""

    image: object
    source_name: str
    result_path: Path
    minimum: float
    maximum: float
    integral: float


def load_result_frames(files, device=None) -> list:
    """Exported npz result fields as :class:`ResultFrame` records (the image
    on ``device``, None: the CUDA card)."""
    frames = []
    for file in files:
        file = Path(file)
        image = imread(file, device=device)
        arr = as_numpy(image.img).astype(float)
        frames.append(
            ResultFrame(
                image=image,
                source_name=file.stem,
                result_path=file,
                minimum=float(arr.min()) if arr.size else 0.0,
                maximum=float(arr.max()) if arr.size else 0.0,
                integral=float(arr.sum()),
            )
        )
    return frames


def _result_npz_files(config) -> list:
    """The npz files of the [helper.results] mode (a mass mode reads the
    mass folder; a missing folder falls back to the mode's own)."""
    mode = config.helper.results.mode
    folder_mode = "mass" if mode in SCALAR_PRODUCT_MODES or "mass" in mode else mode
    source = Path(config.analysis.mass.folder) / folder_mode / "npz"
    if not source.exists():
        source = Path(config.analysis.mass.folder) / mode / "npz"
    return sorted(source.glob("*.npz")) if source.exists() else []


def launch_result_reader(frames: list, *, mode: str, cmap=None) -> None:  # pragma: no cover - interactive
    """Interactive frame stepper with a min/max/integral readout (needs
    matplotlib and a display)."""
    plt = optional_module("matplotlib.pyplot", "The result reader")
    widgets = importlib.import_module("matplotlib.widgets")
    if len(frames) == 0:
        raise ValueError("ResultViewer received no result frames.")
    fig, ax = plt.subplots(figsize=(11, 8))
    plt.subplots_adjust(bottom=0.16)
    state = {"idx": 0, "colorbar": None}

    def _render() -> None:
        ax.cla()
        frame = frames[state["idx"]]
        arr = as_numpy(frame.image.img)
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[..., 0]
        handle = ax.imshow(arr, cmap=cmap or "viridis")
        if state["colorbar"] is None:
            state["colorbar"] = fig.colorbar(handle, ax=ax)
        else:
            state["colorbar"].update_normal(handle)
        ax.set_title(
            f"[{mode}] {frame.source_name} ({state['idx'] + 1}/{len(frames)}) — "
            f"min {frame.minimum:.3g}, max {frame.maximum:.3g}, integral {frame.integral:.3g}"
        )
        fig.canvas.draw_idle()

    def _step(delta: int):
        def _go(_event) -> None:
            state["idx"] = (state["idx"] + delta) % len(frames)
            _render()

        return _go

    prev_btn = widgets.Button(fig.add_axes([0.3, 0.04, 0.1, 0.06]), "Prev")
    next_btn = widgets.Button(fig.add_axes([0.6, 0.04, 0.1, 0.06]), "Next")
    prev_btn.on_clicked(_step(-1))
    next_btn.on_clicked(_step(1))
    _render()
    plt.show()


def helper_result_reader(cls, path, show: bool = False, device=None) -> list:
    """The [helper.results] fields as :class:`ResultFrame` records; with
    ``show`` the interactive viewer opens."""
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="helper", device=device)
    config = ctx.config
    assert config.helper is not None and config.helper.results is not None
    frames = load_result_frames(_result_npz_files(config), device=ctx.fluidflower.device)
    if show:  # pragma: no cover - interactive
        launch_result_reader(
            frames, mode=config.helper.results.mode, cmap=getattr(config.helper.results, "cmap", None)
        )
    return frames


def helper_results(path, cls=None, show: bool = False, device=None) -> list:
    """Re-export the [helper.results] fields into ``results/helper/<mode>``
    as npz, csv, or (with matplotlib) jpg/png; returns the files written."""
    from ..rig import Rig

    ctx = prepare_analysis_context(cls=cls or Rig, path=path, section="helper", device=device)
    config = ctx.config
    assert config.helper is not None and config.helper.results is not None
    results_config = config.helper.results
    out_dir = Path(config.data.results) / "helper" / results_config.mode
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for file in _result_npz_files(config):
        image = imread(file, device=ctx.fluidflower.device)
        if results_config.format == "npz":
            target = out_dir / file.name
            image.save(target)
        elif results_config.format in ("jpg", "png"):
            what = f"Re-exporting results as {results_config.format}"
            optional_module("matplotlib", what).use("Agg")
            plt = optional_module("matplotlib.pyplot", what)
            target = out_dir / f"{file.stem}.{results_config.format}"
            plt.imsave(target, as_numpy(image.img), cmap=results_config.cmap or "viridis")
        elif results_config.format == "csv":
            target = out_dir / f"{file.stem}.csv"
            np.savetxt(target, as_numpy(image.img), delimiter=",")
        else:
            raise ValueError(f"Unsupported format {results_config.format!r}.")
        written.append(target)
    logger.info("Re-exported %d result files to %s.", len(written), out_dir)
    return written
