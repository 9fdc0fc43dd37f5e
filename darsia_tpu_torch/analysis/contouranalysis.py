"""Contour analysis of segmented regions.

Counterpart of :mod:`darsia_tpu.analysis.contouranalysis`.  Contours are
extracted on the host with OpenCV, imported when called (a mask on a
device comes to the host once); the measures and the extrema are numpy on
the contour points.  The overlays (``plot_peaks``, ``plot_valleys``) draw
with matplotlib where it imports.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..image.image import as_numpy
from ..utils.optional import optional_module

__all__ = ["contour_length", "extract_lower_arc", "ContourAnalysis"]


def extract_lower_arc(contour: np.ndarray) -> np.ndarray:
    """Keep the bottom arc of a closed contour (interface extraction).

    A closed contour splits at its leftmost/rightmost points into two arcs;
    the gravitationally lower one (larger mean row index) is the advancing
    interface the fingers step tracks.  Input/output in the cv2 ``(N, 1, 2)``
    (col, row) layout.
    """
    pts = np.asarray(contour).reshape(-1, 2)
    if pts.shape[0] < 3:
        return np.asarray(contour)
    n = pts.shape[0]
    left, right = int(np.argmin(pts[:, 0])), int(np.argmax(pts[:, 0]))
    lo, hi = min(left, right), max(left, right)
    direct = np.arange(lo, hi + 1)
    wrap = np.concatenate([np.arange(hi, n), np.arange(0, lo + 1)])
    lower = (
        direct
        if pts[direct, 1].mean() > pts[wrap, 1].mean()
        else wrap
    )
    return pts[lower].astype(np.int32).reshape(-1, 1, 2)


def _host(img) -> np.ndarray:
    """The data of an image, tensor or array as a host numpy array."""
    return as_numpy(img.img if hasattr(img, "img") else img)


def _scale(img) -> float:
    """The mean of the first two voxel sizes of an image."""
    return float(np.mean(np.asarray(img.voxel_size, dtype=float)[:2]))


def _find_contours(mask: np.ndarray) -> list[np.ndarray]:
    cv2 = optional_module("cv2", "contour extraction")

    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE
    )
    return list(contours)


def contour_length(
    img,
    roi: Optional[tuple] = None,
    values_of_interest: Union[int, list[int], bool] = True,
    fill_holes: bool = True,
    verbosity: bool = False,
    return_contours: bool = False,
):
    """Total physical length of the contour of a (masked) region.

    Args:
        img: boolean/labelled image (Image or array).
        roi: optional voxel ROI restricting the analysis.
        values_of_interest: mask values considered part of the region.
        fill_holes: fill interior holes before measuring.

    Returns:
        float length (meters if a physical Image is given, else pixels);
        optionally also the contours.

    """
    data = _host(img)
    if roi is not None:
        data = data[roi]
    if isinstance(values_of_interest, (int, list)):
        voi = (
            [values_of_interest]
            if isinstance(values_of_interest, int)
            else values_of_interest
        )
        mask = np.isin(data, voi)
    else:
        mask = data.astype(bool)

    if fill_holes:
        from ..utils.morphology import binary_fill_holes

        mask = binary_fill_holes(mask)

    contours = _find_contours(mask)
    length_pixels = 0.0
    cv2 = optional_module("cv2", "contour extraction")

    for c in contours:
        length_pixels += cv2.arcLength(c, closed=True)

    if hasattr(img, "voxel_size"):
        # Convert with the mean voxel size (isotropic warps assumed).
        length = length_pixels * _scale(img)
    else:
        length = length_pixels
    if return_contours:
        return length, contours
    return length


class ContourAnalysis:
    """Analysis of interface contours: length, peaks (fingers), valleys."""

    def __init__(
        self,
        verbosity: bool = False,
        contour_smoother=None,
        reduce_to_main_contour: bool = False,
    ) -> None:
        self.verbosity = verbosity
        self.contour_smoother = contour_smoother
        self.reduce_to_main_contour = reduce_to_main_contour
        self.img = None
        self._mask = None

    def load_labels(
        self,
        img,
        roi: Optional[tuple] = None,
        values_of_interest: Union[int, list[int], bool] = True,
        fill_holes: bool = True,
    ) -> None:
        """Load a (labelled) image and build the analysis mask."""
        self.img = img
        data = _host(img)
        self.roi = roi
        if roi is not None:
            data = data[roi]
        if isinstance(values_of_interest, (int, list)):
            voi = (
                [values_of_interest]
                if isinstance(values_of_interest, int)
                else values_of_interest
            )
            mask = np.isin(data, voi)
        else:
            mask = data.astype(bool)
        if fill_holes:
            from ..utils.morphology import binary_fill_holes

            mask = binary_fill_holes(mask)
        self._mask = mask

    def load(
        self,
        img,
        mask=None,
        roi=None,
        fill_holes: bool = False,
    ) -> None:
        """Load image + boolean mask.

        With ``mask=None`` falls back to the label-based loading of
        :meth:`load_labels` (interpreting ``img`` itself as the mask
        source), so both historic call styles work.
        """
        if mask is None:
            self.load_labels(img, roi=roi, fill_holes=fill_holes)
            return
        self.img = img
        mask_img = mask.subregion(roi) if roi is not None else mask
        data = _host(mask_img).astype(bool)
        if fill_holes:
            from ..utils.morphology import binary_fill_holes

            data = binary_fill_holes(data)
        self.roi = roi
        self._mask = data

    def contours(self) -> list[np.ndarray]:
        assert self._mask is not None, "Call load() first."
        contours = _find_contours(self._mask)
        if self.reduce_to_main_contour and len(contours) > 1:
            cv2 = optional_module("cv2", "contour extraction")
            areas = [cv2.contourArea(c) for c in contours]
            contours = [contours[int(np.argmax(areas))]]
        if self.contour_smoother is not None:
            contours = [self.contour_smoother(c) for c in contours]
        return contours

    def length(self) -> float:
        assert self._mask is not None, "Call load() first."
        cv2 = optional_module("cv2", "contour extraction")

        total = sum(cv2.arcLength(c, True) for c in self.contours())
        if hasattr(self.img, "voxel_size"):
            return total * _scale(self.img)
        return total

    def local_extrema(
        self, direction: Optional[np.ndarray] = None, min_distance: int = 5
    ):
        """Peaks and valleys of the region boundary along a direction.

        Args:
            direction: 2-vector in (col, row) convention; default upward
                (-row), suiting gravity-driven finger analysis.
            min_distance: minimal sample distance between extrema.

        Returns:
            (peaks, valleys): voxel positions (N, 2) each.

        """
        assert self._mask is not None, "Call load() first."
        if direction is None:
            direction = np.array([0.0, -1.0])  # (dx, dy): upward fingers
        peaks_all, valleys_all = [], []
        for c in self.contours():
            pts = c[:, 0, :]  # (N, 2) in (col, row)
            proj = pts[:, 0] * direction[0] + pts[:, 1] * direction[1]
            n = len(proj)
            if n < 3:
                continue
            prev = np.roll(proj, 1)
            nxt = np.roll(proj, -1)
            is_peak = (proj > prev) & (proj >= nxt)
            is_valley = (proj < prev) & (proj <= nxt)
            peaks = pts[is_peak]
            valleys = pts[is_valley]
            peaks_all.extend(self._suppress(peaks, min_distance))
            valleys_all.extend(self._suppress(valleys, min_distance))
        peaks_arr = np.array(peaks_all).reshape(-1, 2)
        valleys_arr = np.array(valleys_all).reshape(-1, 2)
        # Return in (row, col) voxel convention.
        return peaks_arr[:, ::-1], valleys_arr[:, ::-1]

    @staticmethod
    def _suppress(pts: np.ndarray, min_distance: int) -> list:
        kept: list = []
        for p in pts:
            if all(np.linalg.norm(p - q) >= min_distance for q in kept):
                kept.append(p)
        return kept

    def number_peaks(self) -> int:
        peaks, _ = self.local_extrema()
        return len(peaks)

    def number_valleys(self) -> int:
        _, valleys = self.local_extrema()
        return len(valleys)

    def _plot_overlay(
        self,
        img,
        points: Optional[np.ndarray],
        contours: Optional[list],
        path,
        show: bool,
        point_color: str,
        point_size: float,
        contour_color: str,
        contour_linewidth: float,
        contour_alpha: float = 1.0,
        dpi: int = 150,
    ) -> None:
        """Shared contour + marker overlay writer (headless PNG export)."""
        plt = optional_module("matplotlib.pyplot", "a contour overlay")

        background = img if img is not None else self._mask
        data = _host(background)
        fig, ax = plt.subplots()
        if data.ndim == 3 and np.issubdtype(data.dtype, np.floating):
            data = np.clip(data, 0, 1)
        ax.imshow(data, cmap=None if data.ndim == 3 else "gray")
        if contours is None:
            contours = self.contours()
        for c in contours:
            pts = np.asarray(c).reshape(-1, 2)  # (col, row)
            ax.plot(
                pts[:, 0],
                pts[:, 1],
                color=contour_color,
                linewidth=contour_linewidth,
                alpha=contour_alpha,
            )
        if points is not None and len(points) > 0:
            pts = np.asarray(points).reshape(-1, 2)  # (row, col)
            if point_size > 0:
                ax.scatter(
                    pts[:, 1], pts[:, 0], c=point_color, s=point_size, zorder=3
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

    def plot_peaks(
        self,
        img=None,
        peaks: Optional[np.ndarray] = None,
        roi=None,
        contours: Optional[list] = None,
        path=None,
        show: bool = False,
        **kwargs,
    ) -> None:
        """Overlay finger tips (+contours) on the image; save PNG at
        ``path``."""
        if peaks is None:
            peaks, _ = self.local_extrema()
        self._plot_overlay(
            img if img is not None else self.img,
            peaks,
            contours,
            path,
            show,
            point_color=kwargs.get("peak_color", "r"),
            point_size=float(kwargs.get("peak_size", 5)),
            contour_color=kwargs.get("contour_color", "w"),
            contour_linewidth=float(kwargs.get("contour_linewidth", 0.5)),
            contour_alpha=float(kwargs.get("contour_alpha", 1.0)),
        )

    def plot_valleys(
        self,
        img=None,
        valleys: Optional[np.ndarray] = None,
        roi=None,
        contours: Optional[list] = None,
        path=None,
        show: bool = False,
        **kwargs,
    ) -> None:
        """Overlay fjords/valleys (+contours); save PNG at ``path``."""
        if valleys is None:
            _, valleys = self.local_extrema()
        self._plot_overlay(
            img if img is not None else self.img,
            valleys if kwargs.get("plot_valley_dots", True) else None,
            contours,
            path,
            show,
            point_color=kwargs.get("valley_dot_color", "r"),
            point_size=float(kwargs.get("valley_dot_size", 20)),
            contour_color=kwargs.get("contour_color", "w"),
            contour_linewidth=float(kwargs.get("contour_linewidth", 1.0)),
        )
