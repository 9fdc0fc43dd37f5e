"""Finger-detection workflow step.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_fingers`.

Per image and ROI: threshold the configured mode on the rig's device,
extract the (smoothed, optionally main-only) contour of the mask's host
copy (OpenCV), count tips and fjords, skeletonize the mask on its device
(``ops/morphology.py``) and classify leaves / junctions / base junctions,
optionally extract the gradient-based interface (lower contour arc), and
feed every feature category into an identity-preserving
:class:`PathEvolutionAnalysis`.  Outputs the JAX step's folder schema:
``fingers_analysis_results.csv``, ``statistics.csv``, ``statistics.json``
(per-finger physical coordinates, speeds and travel distances),
``paths/<roi>/<roi>_advance_rates.csv`` and ``interface-contour-npy/``.

pandas is not part of the port's environment: the tables are written with
``utils/csv_table.py`` cell for cell as ``DataFrame.to_csv`` writes them
(an existing table is read back and appended to), and the step returns the
rows of ``fingers_analysis_results.csv`` as dicts where the JAX step
returns the frame.  The per-image overlay PNGs (``tips/``, ``fjords/``,
``skeleton/``, the path and interface families) draw with matplotlib; as
in the JAX step a failed drawing is logged as a warning and every table
and JSON is still written.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ....analysis.contouranalysis import (
    ContourAnalysis,
    contour_length,
    extract_lower_arc,
)
from ....analysis.skeleton_analysis import (
    PathEvolutionAnalysis,
    SkeletonAnalysis,
)
from ..mode_resolution import mode_requires_color_to_mass
from ..segmentation_contours import SimpleSegmentation
from ....image.image import as_numpy
from ....utils.csv_table import CsvTable
from .analysis_context import AnalysisContext, prepare_analysis_context
from .progress import publish_image_progress, publish_step_complete, publish_step_start

logger = logging.getLogger(__name__)

__all__ = ["analysis_fingers_from_context", "analysis_fingers"]

#: Feature categories tracked through time; "interface" joins when
#: gradient-based analysis is configured.
CATEGORIES = ("peak", "fjord", "leaf", "junction", "base_junction")

#: statistics.json section per category.
PATH_SECTION = {
    "peak": "paths",
    "fjord": "fjord_paths",
    "leaf": "leaf_paths",
    "junction": "junction_paths",
    "base_junction": "base_junction_paths",
    "interface": "interface_paths",
}

#: Output folder per category's evolution overlay.
PATH_PLOT_DIR = {
    "peak": "paths",
    "leaf": "skeleton-leaf-paths",
    "junction": "skeleton-junction-paths",
    "base_junction": "skeleton-base-junction-paths",
    "interface": "interface-paths",
}


def _roi_slices(roi_config, image) -> tuple:
    voxels = np.asarray(
        image.coordinatesystem.voxel(np.asarray(roi_config.roi, dtype=float))
    )
    lo = np.minimum(voxels[0], voxels[1]).astype(int)
    hi = np.maximum(voxels[0], voxels[1]).astype(int)
    return (slice(max(lo[0], 0), hi[0]), slice(max(lo[1], 0), hi[1]))


def _physical_path(units, roi_offset, coordinatesystem) -> np.ndarray:
    """(T, 2) physical (x, y) coordinates of one tracked path.

    Tracker positions are ROI-local (row, col) voxels; the ROI offset
    shifts them into the global frame before the coordinate map.
    """
    local = np.asarray([u.position for u in units], dtype=float).reshape(-1, 2)
    pixels = local + np.asarray(roi_offset, dtype=float)
    return np.asarray(coordinatesystem.coordinate(pixels)).reshape(-1, 2)


def _path_log(tracker, times_s, roi_offset, coordinatesystem) -> dict:
    """Per-finger log: times, physical coordinates, speeds, travel
    distances."""
    log: dict = {}
    for units in tracker.paths:
        if not units:
            continue
        pid_base = f"path_t{int(units[0].time)}_p{int(units[0].id)}"
        pid, suffix = pid_base, 1
        while pid in log:
            pid = f"{pid_base}_{suffix}"
            suffix += 1
        times = [float(times_s[u.time]) for u in units]
        coords = _physical_path(units, roi_offset, coordinatesystem)
        steps = np.diff(coords, axis=0)
        seg_len = np.hypot(steps[:, 0], steps[:, 1]) if len(steps) else np.zeros(0)
        travel = np.concatenate([[0.0], np.cumsum(seg_len)])
        vertical = np.concatenate(
            [[0.0], np.cumsum(np.abs(steps[:, 1]))] if len(steps) else [[0.0]]
        )
        dts = np.diff(np.asarray(times))
        with np.errstate(divide="ignore", invalid="ignore"):
            vel = np.where(dts[:, None] > 0, steps / dts[:, None], np.nan)
        speeds = np.hypot(vel[:, 0], vel[:, 1]) if len(steps) else np.zeros(0)
        log[pid] = {
            "start": times[0],
            "end": times[-1],
            "time": times,
            "coordinates": coords.tolist(),
            "velocities": vel.tolist(),
            "speed": speeds.tolist(),
            "vertical_speed": vel[:, 1].tolist() if len(steps) else [],
            "travel_distance": travel.tolist(),
            "vertical_travel_distance": np.asarray(vertical).ravel().tolist(),
        }
    return log


def _category_statistics(
    log: dict,
    times_s,
    roi_width: float,
    frequency: float,
    wavelength: float,
    length: float,
) -> dict:
    """Per-time aggregates over the active fingers of one category."""
    stats: dict = {}
    entries = [v for v in log.values() if isinstance(v, dict) and "time" in v]
    for t_idx, t in enumerate(times_s):
        active = []
        for rec in entries:
            if t in rec["time"]:
                i = rec["time"].index(t)
                active.append(
                    {
                        "coordinate": rec["coordinates"][i],
                        "travel_distance": rec["travel_distance"][i],
                        "speed": rec["speed"][i - 1] if i > 0 else float("nan"),
                        "vertical_speed": (
                            rec["vertical_speed"][i - 1]
                            if i > 0
                            else float("nan")
                        ),
                        "new": i == 0,
                        "ending": rec["time"][-1] == t
                        and t_idx < len(times_s) - 1,
                    }
                )
        if not active:
            continue
        xs = np.sort([a["coordinate"][0] for a in active])
        n_new = sum(a["new"] for a in active)
        stats[float(t)] = {
            "horizontal_distances": np.diff(xs).tolist(),
            "coordinates": [a["coordinate"] for a in active],
            "travel_distances": [a["travel_distance"] for a in active],
            "speeds": [a["speed"] for a in active if np.isfinite(a["speed"])],
            "vertical_speeds": [
                a["vertical_speed"]
                for a in active
                if np.isfinite(a["vertical_speed"])
            ],
            "number_new_paths": n_new,
            "number_continuing_paths": len(active) - n_new,
            "number_ending_paths": sum(a["ending"] for a in active),
            "number_active_paths": len(active),
            "roi_width": roi_width,
            "frequency": frequency,
            "wavelength": wavelength,
            "contour_length": length,
        }
    return stats


def analysis_fingers_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    stream_callback: Optional[Callable] = None,
    progress_callback: Optional[Callable] = None,
    write_plots: bool = True,
) -> list:
    """Run the finger analysis over ``ctx.image_paths``; returns the rows of
    ``fingers_analysis_results.csv`` (dicts, in the file's order)."""
    from .analysis_context import iter_prefetched_images

    config = ctx.config
    assert config.analysis is not None and config.analysis.fingers is not None
    fingers_cfg = config.analysis.fingers.config
    if isinstance(fingers_cfg, dict):
        entries = fingers_cfg
    else:
        entries = {"default": fingers_cfg}
    any_gradient = any(
        getattr(e, "include_gradient_based_analysis", False)
        for e in entries.values()
    )
    categories = list(CATEGORIES) + (["interface"] if any_gradient else [])

    folder = Path(config.analysis.fingers.folder)
    folder.mkdir(parents=True, exist_ok=True)
    csv_path = folder / "fingers_analysis_results.csv"
    df = CsvTable.read_or_empty(csv_path)
    stats_path = folder / "statistics.csv"
    stats_df = CsvTable.read_or_empty(stats_path)

    # Identity trackers and per-(entry, roi) bookkeeping.
    evolutions: dict = {}
    roi_offsets: dict = {}
    path_statistics: dict = {
        PATH_SECTION[c]: {} for c in categories
    }
    path_statistics["times"] = []
    path_statistics["images"] = []

    publish_step_start(
        progress_callback, step="fingers", image_total=len(ctx.image_paths)
    )
    started = time.monotonic()
    for index, path, img in iter_prefetched_images(ctx):
        t0 = time.monotonic()
        if img is None:
            continue
        img_time = float(np.asarray(img.time)) if img.time is not None else None
        step_time = img_time if img_time is not None else float(index)
        path_statistics["times"].append(step_time)
        path_statistics["images"].append(path.name)

        mass_result = None
        for key, entry in entries.items():
            if mode_requires_color_to_mass(entry.mode) and mass_result is None:
                assert ctx.color_to_mass_analysis is not None, (
                    "Fingers mode requires color-to-mass analysis."
                )
                mass_result = ctx.color_to_mass_analysis(img)
            seg_kwargs = dict(
                mass_analysis_result=mass_result,
                color_embedding_registry=config.color,
                color_embedding_runtime=ctx.color_embedding_runtime,
            )
            mask = SimpleSegmentation(entry.mode, entry.threshold).extract_mask(
                img, **seg_kwargs
            )
            gradient = getattr(entry, "include_gradient_based_analysis", False)
            gradient_mask = None
            if gradient:
                gmode = getattr(entry, "gradient_mode", None) or entry.mode
                gradient_mask = SimpleSegmentation(gmode, 0.5).extract_mask(
                    img, **seg_kwargs
                )

            rois = entry.roi or {"full": None}
            for roi_key, roi_config in rois.items():
                if roi_config is None:
                    slices = (slice(0, mask.shape[0]), slice(0, mask.shape[1]))
                else:
                    slices = _roi_slices(roi_config, img)
                roi_offset = (slices[0].start, slices[1].start)
                # The mask stays on its device for the skeleton; only its
                # host copy feeds the contours.
                device_mask = mask[slices]
                sub_mask = as_numpy(device_mask)
                if entry.fill_holes:
                    from scipy import ndimage

                    sub_mask = ndimage.binary_fill_holes(sub_mask)
                    device_mask = torch.from_numpy(sub_mask).to(mask.device)

                analysis = ContourAnalysis(
                    contour_smoother=entry.contour_smoother,
                    reduce_to_main_contour=entry.reduce_to_main_contour,
                )
                analysis.load_labels(sub_mask, fill_holes=False)
                contours = analysis.contours()
                peaks, fjords = analysis.local_extrema()
                length = float(contour_length(sub_mask))

                # Skeleton classification, on the mask's device.
                skel = SkeletonAnalysis()
                skel.load(device_mask)
                leaves, junctions, base_junctions = skel.leaves_and_junctions()

                # Gradient-based interface (lower arc) analysis.
                interface_peaks = np.zeros((0, 2), dtype=int)
                lower_arcs: list = []
                if gradient:
                    g_analysis = ContourAnalysis(
                        contour_smoother=entry.contour_smoother,
                        reduce_to_main_contour=entry.reduce_to_main_contour,
                    )
                    g_sub = as_numpy(gradient_mask[slices])
                    if entry.fill_holes:
                        from scipy import ndimage

                        g_sub = ndimage.binary_fill_holes(g_sub)
                    g_analysis.load_labels(g_sub, fill_holes=False)
                    lower_arcs = [
                        extract_lower_arc(c) for c in g_analysis.contours()
                    ]
                    pts = [np.asarray(a).reshape(-1, 2) for a in lower_arcs]
                    if pts:
                        # Peaks of the interface = local minima in row along
                        # the arc (tips of advancing fingers).
                        allpts = np.concatenate(pts)
                        proj = -allpts[:, 1].astype(float)
                        prev = np.roll(proj, 1)
                        nxt = np.roll(proj, -1)
                        sel = (proj > prev) & (proj >= nxt)
                        interface_peaks = allpts[sel][:, ::-1]  # (row, col)

                # ROI width -> finger frequency/wavelength.
                if roi_config is not None:
                    roi_arr = np.asarray(roi_config.roi, dtype=float)
                    roi_width = float(abs(roi_arr[1, 0] - roi_arr[0, 0]))
                else:
                    roi_width = float(
                        sub_mask.shape[1] * float(np.mean(np.asarray(img.voxel_size, dtype=float)[:2]))
                    )
                frequency = len(peaks) / roi_width if roi_width > 0 else 0.0
                wavelength = roi_width / len(peaks) if len(peaks) > 0 else 0.0

                # Identity tracking across the series.
                trackers = evolutions.setdefault(
                    (key, roi_key),
                    {c: PathEvolutionAnalysis() for c in categories},
                )
                roi_offsets[(key, roi_key)] = roi_offset
                points_by_category = {
                    "peak": np.asarray(peaks),
                    "fjord": np.asarray(fjords),
                    "leaf": leaves,
                    "junction": junctions,
                    "base_junction": base_junctions,
                }
                if gradient:
                    points_by_category["interface"] = interface_peaks
                num_paths = {}
                for category in categories:
                    tracker = trackers[category]
                    tracker.add(
                        points_by_category.get(
                            category, np.zeros((0, 2), dtype=int)
                        ),
                        time=step_time,
                    )
                    tracker.find_paths(reset=True)
                    num_paths[category] = tracker.path_counts(
                        tracker.total_time - 1
                    )

                # ---- Per-image overlays ----------------------------------
                if write_plots:
                    try:
                        background = as_numpy(img.img[slices])
                        analysis.plot_peaks(
                            img=background,
                            peaks=peaks,
                            contours=contours,
                            path=folder / "tips" / roi_key / f"{path.stem}.png",
                            show=show,
                        )
                        analysis.plot_valleys(
                            img=background,
                            valleys=fjords,
                            contours=contours,
                            path=folder / "fjords" / roi_key / f"{path.stem}.png",
                            show=show,
                        )
                        skel.plot_skeleton(
                            img=background,
                            leaves=leaves,
                            junctions=junctions,
                            base_junctions=base_junctions,
                            path=folder
                            / "skeleton"
                            / roi_key
                            / f"{path.stem}.png",
                            show=show,
                        )
                        for category in categories:
                            if category == "fjord":
                                continue  # fjords are drawn as points, not as paths
                            trackers[category].plot_paths(
                                img=background,
                                path=folder
                                / PATH_PLOT_DIR[category]
                                / roi_key
                                / f"{path.stem}.png",
                            )
                        if gradient:
                            g_analysis.plot_peaks(
                                img=background,
                                peaks=interface_peaks,
                                contours=lower_arcs,
                                path=folder
                                / "interface"
                                / roi_key
                                / f"{path.stem}.png",
                                show=show,
                                peak_size=5,
                                contour_alpha=0.5,
                            )
                            g_analysis.plot_peaks(
                                img=background,
                                peaks=np.zeros((0, 2)),
                                contours=lower_arcs,
                                path=folder
                                / "interface-contour"
                                / roi_key
                                / f"{path.stem}.png",
                                show=show,
                                peak_size=0,
                                contour_alpha=0.5,
                            )
                    except Exception as exc:  # plots must not fail analysis
                        logger.warning(
                            "Overlay plot failed for %s/%s: %s",
                            key,
                            roi_key,
                            exc,
                        )
                if gradient:
                    # Physical-coordinate interface export (.npy).
                    npy_dir = folder / "interface-contour-npy" / roi_key
                    npy_dir.mkdir(parents=True, exist_ok=True)
                    arcs_physical = [
                        np.asarray(
                            img.coordinatesystem.coordinate(
                                np.asarray(a).reshape(-1, 2)[:, ::-1]
                                + np.asarray(roi_offset)
                            ),
                            dtype=np.float32,
                        )
                        for a in lower_arcs
                    ]
                    np.save(
                        npy_dir / f"{path.stem}.npy",
                        np.asarray(arcs_physical, dtype=object),
                        allow_pickle=True,
                    )

                # ---- Path log + per-time statistics (statistics.json) -----
                times_s = trackers["peak"].times
                for category in categories:
                    log = _path_log(
                        trackers[category],
                        trackers[category].times,
                        roi_offset,
                        img.coordinatesystem,
                    )
                    log["statistics"] = _category_statistics(
                        log, times_s, roi_width, frequency, wavelength, length
                    )
                    section = path_statistics[PATH_SECTION[category]]
                    roi_entry = section.setdefault(roi_key, {})
                    if roi_config is not None and "roi" not in roi_entry:
                        roi_entry["roi"] = np.asarray(
                            roi_config.roi, dtype=float
                        ).tolist()
                    roi_entry.update(log)

                # ---- Tabular statistics -------------------------------------
                stats_row = {
                    "time": img_time,
                    "key": roi_key,
                    "image": path.name,
                    "contour_length": length,
                    "number_tips": int(len(peaks)),
                    "number_fjords": int(len(fjords)),
                    "number_leaves": int(len(leaves)),
                    "number_junctions": int(len(junctions)),
                    "number_base_junctions": int(len(base_junctions)),
                    "number_skeleton_leaves": num_paths["leaf"]["active"],
                    "number_skeleton_junctions": num_paths["junction"][
                        "active"
                    ],
                    "roi_width": roi_width,
                    "finger_frequency": frequency,
                    "finger_wavelength": wavelength,
                }
                for category, stem in (
                    ("peak", "fingers"),
                    ("leaf", "skeleton_leaves"),
                    ("base_junction", "base_fingers"),
                    ("junction", "splitting_fingers"),
                ):
                    stats_row[f"number_{stem}"] = num_paths[category]["active"]
                    stats_row[f"number_new_{stem}"] = num_paths[category]["new"]
                    stats_row[f"number_continuing_{stem}"] = num_paths[
                        category
                    ]["continuing"]
                    stats_row[f"number_ending_{stem}"] = num_paths[category][
                        "ending"
                    ]
                if gradient:
                    for field in ("active", "new", "continuing", "ending"):
                        col = {
                            "active": "number_interface_fingers",
                            "new": "number_new_interface_fingers",
                            "continuing": "number_continuing_interface_fingers",
                            "ending": "number_ending_interface_fingers",
                        }[field]
                        stats_row[col] = num_paths["interface"][field]
                stats_df.append(stats_row)

                # Compact per-image row (pre-existing CSV kept for
                # backwards compatibility with earlier rounds' outputs).
                row = {
                    "time": img_time,
                    "image_stem": path.stem,
                    "entry": key,
                    "roi": roi_key,
                    "contour_length": length,
                    "number_fingers": int(len(peaks)),
                    "area_fraction": float(sub_mask.mean()),
                }
                if entry.include_skeleton_analysis:
                    row["skeleton_length"] = skel.skeleton_length()
                    row["number_tips"] = int(len(leaves))
                df.append(row)

        df.write(csv_path)
        stats_df.write(stats_path)
        with open(folder / "statistics.json", "w") as f:
            json.dump(path_statistics, f, indent=2)
        publish_image_progress(
            progress_callback,
            step="fingers",
            image_path=str(path),
            image_index=index,
            image_total=len(ctx.image_paths),
            image_duration_s=time.monotonic() - t0,
        )

    # Advance-rate export per (entry, roi) from the peak tracker.
    for (key, roi_key), trackers in evolutions.items():
        plot_dir = folder / "paths" / roi_key
        plot_dir.mkdir(parents=True, exist_ok=True)
        rates = trackers["peak"].advance_rates()
        if rates:
            table = CsvTable()
            for rate in rates:
                table.append(rate)
            table.write(plot_dir / f"{roi_key}_advance_rates.csv")

    publish_step_complete(
        progress_callback,
        step="fingers",
        step_elapsed_s=time.monotonic() - started,
    )
    return df.records()


def analysis_fingers(path, cls=None, all: bool = False, device=None, **kwargs) -> list:
    """Prepare the context on ``device`` (None: the CUDA card) and run the
    finger analysis."""
    from ..rig import Rig

    ctx = prepare_analysis_context(
        cls=cls or Rig, path=path, all=all, require_color_to_mass=True, device=device
    )
    return analysis_fingers_from_context(ctx, **kwargs)
