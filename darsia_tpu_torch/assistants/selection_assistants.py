"""Point, box, rectangle, subregion and rotation selection assistants.

Counterpart of :mod:`darsia_tpu.assistants.selection_assistants`.  Each
takes its selection as an argument for headless use (``points=``,
``corners=``, ``coordinates=``); otherwise it collects clicks through the
matplotlib event loop of :class:`BaseAssistant`.  The results are host
values (voxel arrays, slices, coordinates) and a
:class:`~darsia_tpu_torch.corrections.shape.rotation.RotationCorrection`.
"""

from __future__ import annotations

import numpy as np

from ..corrections.shape.rotation import RotationCorrection
from ..utils.point import VoxelArray, make_voxel
from .base_assistant import BaseAssistant

__all__ = [
    "PointSelectionAssistant",
    "BoxSelectionAssistant",
    "RectangleSelectionAssistant",
    "SubregionAssistant",
    "RotationCorrectionAssistant",
]


def _space_shape(img) -> tuple:
    return tuple(int(n) for n in (img.img if hasattr(img, "img") else img).shape[:2])


class PointSelectionAssistant(BaseAssistant):
    """Collect points in matrix (row, col) voxel indexing.

    Interactive loop: a left click adds a point, ``d`` removes the last one,
    ``escape`` resets, ``enter`` finalizes.  ``points=[...]`` skips it.
    """

    def __init__(self, img, points=None, **kwargs) -> None:
        super().__init__(img, **kwargs)
        self.pts: list = []
        if points is not None:
            self.pts = [np.asarray(p, dtype=float) for p in points]
        self.finalized = False
        self._markers: list = []

    def _reset(self) -> None:
        self.pts = []
        self.finalized = False
        for artist in self._markers:
            try:
                artist.remove()
            except (ValueError, NotImplementedError):
                pass
        self._markers = []

    def _finalize(self) -> None:
        self.finalized = True
        super()._finalize()

    def _print_instructions(self) -> None:
        if self.verbosity:
            print(
                "Left-click to add a point; 'd' removes the last point; "
                "'escape' resets; 'enter' finalizes."
            )

    def _setup_event_handler(self) -> None:
        super()._setup_event_handler()
        self.fig.canvas.mpl_connect("button_press_event", self._on_mouse_click)

    def _on_mouse_click(self, event) -> None:
        self._print_event(event)
        if event.xdata is None or event.ydata is None:
            return
        if getattr(event, "button", 1) not in (1, None):
            return
        # Matplotlib gives (x, y); the points are (row, col).
        self.pts.append(np.array([event.ydata, event.xdata]))
        (marker,) = self.ax.plot(event.xdata, event.ydata, "r+", markersize=10)
        self._markers.append(marker)
        self.fig.canvas.draw_idle()

    def _on_key_press(self, event) -> None:
        if event.key == "d":
            self._remove_last_point()
            return
        super()._on_key_press(event)

    def _remove_last_point(self) -> None:
        if not self.pts:
            return
        self.pts.pop()
        if self._markers:
            try:
                self._markers.pop().remove()
            except (ValueError, NotImplementedError):
                pass
        if self.fig is not None:
            self.fig.canvas.draw_idle()

    def __call__(self) -> VoxelArray:
        if not self.pts:
            super().__call__()
        return make_voxel(np.asarray(self.pts))


class BoxSelectionAssistant(PointSelectionAssistant):
    """Points -> square boxes of a given width (a list of slice tuples)."""

    def __init__(self, img, background=None, width: int = 100, **kwargs) -> None:
        super().__init__(img, **kwargs)
        self.background = background
        self.width = width

    def _convert_pts(self) -> list:
        half = self.width // 2
        shape = _space_shape(self.img)
        boxes = []
        for pt in self.pts:
            row, col = int(pt[0]), int(pt[1])
            boxes.append(
                (
                    slice(max(row - half, 0), min(row + half, shape[0])),
                    slice(max(col - half, 0), min(col + half, shape[1])),
                )
            )
        return boxes

    def __call__(self) -> list:
        if not self.pts:
            BaseAssistant.__call__(self)
        return self._convert_pts()


class RectangleSelectionAssistant(PointSelectionAssistant):
    """Two points -> one rectangle as a (slice, slice) tuple."""

    def __init__(self, img, labels=None, corners=None, **kwargs) -> None:
        super().__init__(img, points=corners, **kwargs)
        self.labels = labels

    def __call__(self) -> tuple:
        if not self.pts:
            BaseAssistant.__call__(self)
        assert len(self.pts) >= 2, "Select two corners."
        pts = np.asarray(self.pts[:2])
        lo = np.floor(pts.min(axis=0)).astype(int)
        hi = np.ceil(pts.max(axis=0)).astype(int)
        return (slice(lo[0], hi[0]), slice(lo[1], hi[1]))


class SubregionAssistant(BaseAssistant):
    """Two points -> the (2, 2) array of their physical coordinates."""

    def __init__(self, img, coordinates=None, **kwargs) -> None:
        super().__init__(img, **kwargs)
        self._coordinates = None if coordinates is None else np.asarray(coordinates, float)
        self._clicks: list = []

    def _setup_event_handler(self) -> None:
        super()._setup_event_handler()
        self.fig.canvas.mpl_connect("button_press_event", self._on_mouse_click)

    def _on_mouse_click(self, event) -> None:
        if event.xdata is None or event.ydata is None:
            return
        voxel = np.array([event.ydata, event.xdata])
        self._clicks.append(np.asarray(self.img.coordinatesystem.coordinate(voxel)))

    def __call__(self) -> np.ndarray:
        if self._coordinates is None:
            super().__call__()
            assert len(self._clicks) >= 2, "Select two corners."
            self._coordinates = np.asarray(self._clicks[:2])
        return self._coordinates


class RotationCorrectionAssistant(BaseAssistant):
    """Two points on a line -> a RotationCorrection that aligns the line
    with an image axis."""

    def __init__(self, img, points=None, axis: int = 1, **kwargs) -> None:
        super().__init__(img, **kwargs)
        self._points = None if points is None else np.asarray(points, float)
        self._clicks: list = []
        self.axis = axis

    def _setup_event_handler(self) -> None:
        super()._setup_event_handler()
        self.fig.canvas.mpl_connect("button_press_event", self._on_mouse_click)

    def _on_mouse_click(self, event) -> None:
        if event.xdata is None or event.ydata is None:
            return
        self._clicks.append(np.array([event.ydata, event.xdata]))

    def __call__(self) -> list:
        if self._points is None:
            super().__call__()
            assert len(self._clicks) >= 2, "Select two points."
            self._points = np.asarray(self._clicks[:2])
        src = self._points
        anchor = src[0]
        # The target: the segment turned onto the chosen axis.
        direction = src[1] - src[0]
        length = float(np.linalg.norm(direction))
        target_dir = np.zeros(2)
        target_dir[self.axis] = np.sign(direction[self.axis]) or 1.0
        dst = np.stack([anchor, anchor + length * target_dir])
        return [
            RotationCorrection(
                anchor=anchor, rotation_from_isometry=True, pts_src=src, pts_dst=dst
            )
        ]
