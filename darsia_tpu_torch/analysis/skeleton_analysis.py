"""Skeletonization + finger-path evolution analysis.

Counterpart of :mod:`darsia_tpu.analysis.skeleton_analysis`.
:class:`SkeletonAnalysis` computes the morphological skeleton of a mask
where the mask lives: as boolean tensor ops on its device
(``ops/morphology.py::skeletonize``, bit for bit the host
``utils/morphology.py::skeletonize``, which stays as the plain version); a
numpy mask goes to ``device``, the CUDA card when None.  The endpoint and
branch-point counts run on the same device; the classified feature points
come to the host as numpy arrays.  :class:`PathEvolutionAnalysis` (identity
tracking over a series) is host numpy, copied.  The overlays draw with
matplotlib where it imports; contours come from OpenCV, imported when
called.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from ..image.image import as_numpy, as_tensor
from ..ops.morphology import neighbour_count, skeletonize
from ..utils.optional import optional_module

__all__ = ["SkeletonAnalysis", "PathEvolutionAnalysis", "PathUnit"]


def _pyplot():
    return optional_module("matplotlib.pyplot", "a skeleton or path overlay")


class SkeletonAnalysis:
    """Skeletonize binary masks and measure skeleton properties.

    ``skeleton(contours)``: contours (or the loaded mask's main contour),
    optionally smoothed, filled and skeletonized.  The computed pixel mask
    is retained as ``skeleton_mask`` (a boolean tensor on the mask's
    device) for the measurement helpers, and the number of erosions the
    skeleton took as ``iterations``.
    """

    def __init__(
        self,
        verbosity: bool = False,
        contour_smoother=None,
        reduce_to_main_contour: bool = False,
        device=None,
    ) -> None:
        self.verbosity = verbosity
        self.contour_smoother = contour_smoother
        self.reduce_to_main_contour = reduce_to_main_contour
        self.device = device
        self.skeleton_mask: Optional[torch.Tensor] = None
        self.iterations = 0
        self.contour: Optional[np.ndarray] = None
        self.mask: Optional[torch.Tensor] = None
        self.img = None

    def load(self, img, roi: Optional[tuple] = None, fill_holes: bool = False) -> None:
        self.img = img
        data = img.img if hasattr(img, "img") else img
        if roi is not None:
            data = data[roi]
        if fill_holes:
            from scipy import ndimage

            where = data.device if isinstance(data, torch.Tensor) else self.device
            data = as_tensor(ndimage.binary_fill_holes(as_numpy(data).astype(bool)), where)
        self.mask = as_tensor(data, self.device).to(torch.bool)
        self.skeleton_mask, self.iterations = skeletonize(self.mask)

    def skeleton(self, contours=None) -> Optional[torch.Tensor]:
        """Skeleton of the loaded mask, via its (smoothed) contour.

        Extract contours when none are given, optionally reduce to the
        largest-area contour, smooth, fill the polygon, and skeletonize the
        filled mask.  Returns the boolean skeleton pixel mask (also stored
        as ``skeleton_mask``) or ``None`` when no contour exists.
        """
        cv2 = optional_module("cv2", "SkeletonAnalysis.skeleton")

        if contours is None:
            assert self.mask is not None, "Call load() first."
            found, _ = cv2.findContours(
                as_numpy(self.mask).astype(np.uint8),
                cv2.RETR_TREE,
                cv2.CHAIN_APPROX_NONE,
            )
            contours = list(found)
        if len(contours) == 0:
            self.contour = None
            return None
        if self.reduce_to_main_contour and len(contours) > 1:
            areas = [cv2.contourArea(np.asarray(c, np.int32)) for c in contours]
            contours = [contours[int(np.argmax(areas))]]
        if self.contour_smoother is not None:
            contours = [self.contour_smoother(c) for c in contours]
        assert len(contours) == 1, (
            "Skeletonization currently only implemented for one contour."
        )
        self.contour = np.asarray(contours[0], dtype=np.int32)
        shape = (
            tuple(self.mask.shape)
            if self.mask is not None
            else (
                int(self.contour.reshape(-1, 2)[:, 1].max()) + 1,
                int(self.contour.reshape(-1, 2)[:, 0].max()) + 1,
            )
        )
        contour_mask = np.zeros(shape, dtype=np.uint8)
        cv2.fillPoly(contour_mask, [self.contour.reshape(-1, 1, 2)], color=1)
        where = self.mask.device if self.mask is not None else self.device
        self.skeleton_mask, self.iterations = skeletonize(as_tensor(contour_mask.astype(bool), where))
        return self.skeleton_mask

    def skeleton_length(self) -> float:
        """Approximate physical length of the skeleton."""
        assert self.skeleton_mask is not None, "Call load() first."
        n = int(self.skeleton_mask.sum())
        if hasattr(self.img, "voxel_size"):
            return n * float(np.mean(np.asarray(self.img.voxel_size, dtype=float)[:2]))
        return float(n)

    def endpoints(self) -> np.ndarray:
        """Skeleton endpoints (pixels with exactly one neighbour)."""
        assert self.skeleton_mask is not None
        mask = self.skeleton_mask & (neighbour_count(self.skeleton_mask) == 2)  # self + 1 neighbour
        return torch.nonzero(mask).cpu().numpy()

    def branch_points(self) -> np.ndarray:
        """Skeleton branch points (pixels with 3+ neighbours)."""
        assert self.skeleton_mask is not None
        mask = self.skeleton_mask & (neighbour_count(self.skeleton_mask) >= 4)
        return torch.nonzero(mask).cpu().numpy()

    def _top_line(self) -> np.ndarray:
        """Per-column topmost skeleton pixel (row, col): the injection
        front the fingers hang from."""
        pixels = torch.nonzero(self.skeleton_mask).cpu().numpy()
        if pixels.size == 0:
            return np.zeros((0, 2), dtype=int)
        order = np.lexsort((pixels[:, 0], pixels[:, 1]))  # by col, then row
        pixels = pixels[order]
        first = np.concatenate(
            [[True], pixels[1:, 1] != pixels[:-1, 1]]
        )  # first (== topmost) entry per column
        return pixels[first]

    @staticmethod
    def _group_points(points: np.ndarray, max_distance: float, prefer=None):
        """Greedy Manhattan clustering; one representative per group.

        ``prefer``: set of (row, col) tuples whose members win group
        representation (top-line anchoring).
        """
        if len(points) == 0:
            return points
        remaining = np.asarray(points)
        reps = []
        while len(remaining):
            d = np.abs(remaining - remaining[0]).sum(axis=1)
            group = remaining[d < max_distance]
            rep = group[0]
            if prefer:
                for p in group:
                    if tuple(p) in prefer:
                        rep = p
                        break
            reps.append(rep)
            remaining = remaining[d >= max_distance]
        return np.asarray(reps)

    def leaves_and_junctions(
        self, max_group_distance: float = 5.0
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Classified skeleton feature points (leaves / junctions / base).

        Degree-1 pixels below the top line are finger tips ("leaves");
        degree>2 pixels off the top line are finger splits ("junctions");
        degree>2 pixels ON the top line are base junctions where fingers
        root (the 8-neighbour count is the skeleton graph's degree plus
        one).  Nearby points
        are merged within ``max_group_distance`` pixels (Manhattan).

        Returns:
            (leaves, junctions, base_junctions) as (N, 2) (row, col) arrays.
        """
        assert self.skeleton_mask is not None, "Call load() first."
        empty = np.zeros((0, 2), dtype=int)
        if not bool(self.skeleton_mask.any()):
            return empty, empty, empty

        top = self._top_line()
        top_set = {tuple(p) for p in top}
        top_min_row = int(top[:, 0].min())

        endpoints = self.endpoints()
        branches = self.branch_points()
        leaves = (
            endpoints[endpoints[:, 0] >= top_min_row]
            if len(endpoints)
            else empty
        )
        on_top = (
            np.array([tuple(p) in top_set for p in branches], dtype=bool)
            if len(branches)
            else np.zeros(0, dtype=bool)
        )
        junctions = branches[~on_top] if len(branches) else empty
        base = branches[on_top] if len(branches) else empty

        leaves = self._group_points(leaves, max_group_distance)
        junctions = self._group_points(junctions, max_group_distance)
        base = self._group_points(base, max_group_distance, prefer=top_set)
        return (
            leaves.reshape(-1, 2),
            junctions.reshape(-1, 2),
            base.reshape(-1, 2),
        )

    def plot_skeleton(
        self,
        img=None,
        skeleton: Optional[np.ndarray] = None,
        leaves: Optional[np.ndarray] = None,
        junctions: Optional[np.ndarray] = None,
        base_junctions: Optional[np.ndarray] = None,
        roi=None,
        path=None,
        show: bool = False,
        dpi: int = 150,
        **kwargs,
    ) -> None:
        """Skeleton overlay with classified feature points; PNG export."""
        plt = _pyplot()

        skeleton = as_numpy(skeleton if skeleton is not None else self.skeleton_mask)
        background = img if img is not None else skeleton
        data = as_numpy(background.img if hasattr(background, "img") else background)
        fig, ax = plt.subplots()
        if data.ndim == 3 and np.issubdtype(data.dtype, np.floating):
            data = np.clip(data, 0, 1)
        ax.imshow(data, cmap=None if data.ndim == 3 else "gray")
        ys, xs = np.nonzero(skeleton)
        ax.scatter(
            xs,
            ys,
            s=float(kwargs.get("skeleton_linewidth", 1.0)),
            c=kwargs.get("skeleton_color", "w"),
            marker=".",
        )
        for pts, color_key, size_key, default_color in (
            (leaves, "leaf_color", "leaf_size", "g"),
            (junctions, "junction_color", "junction_size", "m"),
            (base_junctions, "base_junction_color", "base_junction_size", "b"),
        ):
            if pts is not None and len(pts):
                arr = np.asarray(pts).reshape(-1, 2)
                ax.scatter(
                    arr[:, 1],
                    arr[:, 0],
                    s=float(kwargs.get(size_key, 20)),
                    c=kwargs.get(color_key, default_color),
                    zorder=3,
                )
        ax.set_axis_off()
        if path is not None:
            from pathlib import Path as _P

            out = _P(path)
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(out, dpi=dpi, bbox_inches="tight", pad_inches=0)
        if show:  # pragma: no cover - interactive
            plt.show()
        else:
            plt.close(fig)


# A uniquely identified location within the collection of paths.
PathUnit = namedtuple("PathUnit", ["time", "id", "position"])


class PathEvolutionAnalysis:
    """Track evolving point features (finger tips, skeleton leaves, ...)
    across a time series, assigning per-finger identity.

    Points added per time step are matched to the previous step's points by
    an ordered recursive nearest-pair rule (the globally closest pair splits
    the remaining candidates into "before" and "after" blocks, preserving
    lateral finger ordering), connected matches extend existing paths,
    unmatched new points start new paths.  ``add_mask`` skeletonizes on
    ``device`` (the mask's own for a tensor, the CUDA card for numpy when
    None).
    """

    def __init__(self, verbosity: bool = False, device=None) -> None:
        self.device = device
        self.points: dict[int, np.ndarray] = {}
        self.paths: list[list[PathUnit]] = []
        self.verbosity = verbosity
        self.times: list[float] = []
        self.total_time: int = 0
        self.history: list[dict] = []  # mask-level records (add_mask)

    # ------------------------------------------------------------ ingestion

    def add(self, points: np.ndarray, time: Optional[float] = None) -> None:
        """Add (N, 2) points for a new time step."""
        if time is None:
            raise ValueError("Time cannot be None when adding points.")
        self.times.append(float(time))
        self.times.sort()
        index = self.times.index(float(time))
        self.points = {i + (i >= index): p for i, p in self.points.items()}
        self.points[index] = np.asarray(points).copy()
        self.total_time = len(self.times)

    def add_mask(self, img, time: Optional[float] = None) -> dict:
        """Analyze one mask time step: skeleton, tips, advance metrics.

        Tips (skeleton endpoints) are fed into the path tracker; the
        returned record carries the per-step skeleton statistics the
        fingers workflow step consumes.
        """
        analysis = SkeletonAnalysis(device=self.device)
        analysis.load(img)
        tips = analysis.endpoints()
        junctions = analysis.branch_points()
        t = time if time is not None else float(len(self.history))
        self.add(tips, time=t)
        record = {
            "time": time,
            "skeleton_length": analysis.skeleton_length(),
            "num_fingers": len(tips),
            "tips": tips,
            "num_junctions": len(junctions),
        }
        if self.history:
            prev = self.history[-1]
            record["length_growth"] = (
                record["skeleton_length"] - prev["skeleton_length"]
            )
        self.history.append(record)
        return record

    # --------------------------------------------------------- path finding

    def _find_paths(self, points: dict[int, np.ndarray]) -> list:
        paths: list[list[PathUnit]] = []

        def _reshape(array: np.ndarray) -> np.ndarray:
            arr = np.asarray(array)
            if arr.size == 0:
                return np.zeros((0, 2), dtype=int)
            return np.squeeze(arr).reshape(-1, 2)

        def _same_unit(a: PathUnit, b: PathUnit) -> bool:
            return a.time == b.time and np.allclose(a.position, b.position)

        def _include_segments(t_prev, t_next, segments, pts_prev, pts_next):
            for segment in segments:
                unit_prev = PathUnit(t_prev, segment[0], pts_prev[segment[0]])
                unit_next = PathUnit(t_next, segment[1], pts_next[segment[1]])
                for path in paths:
                    if _same_unit(path[-1], unit_prev):
                        path.append(unit_next)
                        break
                else:
                    paths.append([unit_prev, unit_next])

        def _include_points(t_next, indices, pts_next):
            for i in indices:
                paths.append([PathUnit(t_next, i, pts_next[i])])

        if self.total_time == 1:
            pts = _reshape(points.get(0, np.zeros((0, 2), dtype=int)))
            _include_points(0, range(len(pts)), pts)
            return paths

        for t in range(self.total_time - 1):
            pts_prev = _reshape(points.get(t, np.zeros((0, 2), dtype=int)))
            pts_next = _reshape(points.get(t + 1, np.zeros((0, 2), dtype=int)))

            pairs: list[np.ndarray] = []
            new_paths: list[int] = []

            if len(pts_prev) == 0 and len(pts_next) > 0:
                _include_points(t + 1, range(len(pts_next)), pts_next)
                continue
            if len(pts_next) == 0 or len(pts_prev) == 0:
                continue

            # Ordered recursive matching: the globally nearest pair splits
            # the candidate index blocks (keeps lateral finger ordering).
            dist = np.linalg.norm(
                pts_prev[:, None, :].astype(float)
                - pts_next[None, :, :].astype(float),
                axis=-1,
            )
            blocks = [(slice(0, len(pts_prev)), slice(0, len(pts_next)))]
            for _ in range(max(len(pts_prev), len(pts_next))):
                if not blocks:
                    break
                ind_prev, ind_next = blocks.pop(0)
                local = dist[ind_prev, ind_next]
                ncols = local.shape[1]
                flat = int(np.argmin(np.ravel(local)))
                argmin = np.array([flat // ncols, flat % ncols]) + np.array(
                    [ind_prev.start, ind_next.start]
                )
                pairs.append(argmin)

                pre = (
                    slice(ind_prev.start, argmin[0]),
                    slice(ind_next.start, argmin[1]),
                )
                post = (
                    slice(argmin[0] + 1, ind_prev.stop),
                    slice(argmin[1] + 1, ind_next.stop),
                )

                def _nonempty(sl: slice) -> bool:
                    return sl.stop - sl.start > 0

                if _nonempty(post[0]) and _nonempty(post[1]):
                    blocks.insert(0, post)
                elif _nonempty(post[1]):
                    new_paths.extend(range(post[1].start, post[1].stop))
                if _nonempty(pre[0]) and _nonempty(pre[1]):
                    blocks.insert(0, pre)
                elif _nonempty(pre[1]):
                    new_paths.extend(range(pre[1].start, pre[1].stop))

            pairs_arr = np.array(pairs).reshape(-1, 2)
            if pairs_arr.shape[0] > 0:
                pairs_arr = pairs_arr[np.argsort(pairs_arr[:, 0])]
            new_arr = np.sort(np.array(new_paths, dtype=int))
            _include_segments(t, t + 1, pairs_arr, pts_prev, pts_next)
            _include_points(t + 1, new_arr, pts_next)

        return paths

    def find_paths(self, reset: bool = True) -> None:
        if reset:
            self.paths = []
        self.paths.extend(self._find_paths(self.points))

    # ----------------------------------------------------------- statistics

    def path_counts(self, time_index: int) -> dict:
        """Per-step identity statistics: active / new / continuing / ending
        finger counts (the fingers step's statistics schema)."""
        if not self.paths:
            self.find_paths()
        active = new = continuing = ending = 0
        for path in self.paths:
            times = [unit.time for unit in path]
            if time_index in times:
                active += 1
                if times[0] == time_index:
                    new += 1
                else:
                    continuing += 1
                if times[-1] == time_index and time_index < self.total_time - 1:
                    ending += 1
        return {
            "active": active,
            "new": new,
            "continuing": continuing,
            "ending": ending,
        }

    def advance_rates(self) -> list[dict]:
        """Per-finger advance statistics over each path's lifetime."""
        if not self.paths:
            self.find_paths()
        stats = []
        for i, path in enumerate(self.paths):
            positions = np.asarray([unit.position for unit in path], dtype=float)
            t0, t1 = path[0].time, path[-1].time
            times = [self.times[unit.time] for unit in path]
            duration = times[-1] - times[0] if len(times) > 1 else 0.0
            total = (
                float(np.linalg.norm(positions[-1] - positions[0]))
                if len(positions) > 1
                else 0.0
            )
            stats.append(
                {
                    "path_id": i,
                    "birth_index": int(t0),
                    "death_index": int(t1),
                    "lifetime_steps": len(path),
                    "total_advance": total,
                    "advance_rate": total / duration if duration > 0 else 0.0,
                }
            )
        return stats

    def tip_advance(self) -> np.ndarray:
        """Per-step maximal tip advance (rows) over the mask history."""
        advances = []
        for prev, curr in zip(self.history[:-1], self.history[1:]):
            if len(prev["tips"]) == 0 or len(curr["tips"]) == 0:
                advances.append(0.0)
                continue
            advances.append(
                float(curr["tips"][:, 0].max() - prev["tips"][:, 0].max())
            )
        return np.array(advances)

    # ------------------------------------------------------------- plotting

    def plot_paths(
        self,
        img=None,
        roi=None,
        path=None,
        show: bool = False,
        dpi: int = 300,
        **kwargs,
    ) -> None:
        """Overlay tracked paths on an image, line width scaled by path
        length."""
        plt = _pyplot()

        if img is None:
            raise ValueError("img cannot be None when plotting paths.")
        if not self.paths:
            self.find_paths()

        data = as_numpy(img.img if hasattr(img, "img") else img)
        plt.figure("Paths")
        plt.imshow(data)

        max_len = max(
            (len(p) for p in self.paths), default=1
        )
        color = kwargs.get("color", "viridis")
        cmap = (
            plt.get_cmap(color)
            if color in plt.colormaps()
            else (lambda _x: color)
        )
        alpha = kwargs.get("alpha", 1.0)
        denominator = max(len(self.paths) - 1, 1)
        for i, p in enumerate(self.paths):
            pos = np.asarray([unit.position for unit in p])
            plt.plot(
                pos[:, 1],
                pos[:, 0],
                color=cmap(i / denominator),
                linewidth=max(len(p) / max_len * 2, 0.5),
                alpha=alpha,
            )
        plt.axis("off")
        if path is not None:
            from pathlib import Path as _P

            out = _P(path)
            if out.suffix not in (".png", ".jpg", ".jpeg", ".svg"):
                out = out.with_suffix(".png")
            out.parent.mkdir(parents=True, exist_ok=True)
            plt.savefig(out, dpi=dpi, bbox_inches="tight", pad_inches=0)
        if show:
            plt.show()
        else:
            plt.close()
