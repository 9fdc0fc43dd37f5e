"""Time-selection data for calibration/analysis subsets.

Parity: reference ``presets/workflows/config/time_data.py:15-333``
(TimeInterval, TimeWindow, TimeData) — compact declarative variant.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from .toml_utils import convert_to_hours

__all__ = [
    "TimeInterval",
    "TimeWindow",
    "TimeData",
    "ImageTimeData",
    "ImageTimeIntervalData",
    "PathData",
]


@dataclass
class TimeInterval:
    """Uniformly sampled time interval [start, end] in hours."""

    start: float
    end: float
    step: Optional[float] = None
    num: Optional[int] = None
    tol: Optional[float] = None

    def times(self) -> list:
        if self.num is not None:
            return np.linspace(self.start, self.end, self.num).tolist()
        step = self.step if self.step else (self.end - self.start)
        return np.arange(self.start, self.end + 0.5 * step, step).tolist()

    def generate_times(self) -> list:
        """Unique sample times (reference time_data.py:49-51)."""
        return np.unique(self.times()).tolist()

    def generate_times_with_uncertainty(self) -> list:
        """(time, tol) pairs (reference time_data.py:52-55)."""
        tol = self.tol if self.tol is not None else 0.0
        return [(t, tol) for t in self.generate_times()]

    @classmethod
    def from_dict(cls, data: dict) -> "TimeInterval":
        return cls(
            start=convert_to_hours(data["start"]),
            end=convert_to_hours(data["end"]),
            step=convert_to_hours(data["step"]) if "step" in data else None,
            num=int(data["num"]) if "num" in data else None,
            tol=convert_to_hours(data["tol"]) if "tol" in data else None,
        )


@dataclass
class TimeWindow:
    """Closed time window [start, end] in hours."""

    start: float
    end: float

    def contains(self, time: float) -> bool:
        return self.start <= time <= self.end

    @classmethod
    def from_dict(cls, data: dict) -> "TimeWindow":
        return cls(
            start=convert_to_hours(data["start"]),
            end=convert_to_hours(data["end"]),
        )


@dataclass
class TimeData:
    """Aggregated image selection: explicit times, intervals/windows, paths.

    TOML shape (sub-sections of any owning section):
        times = [0.5, "01:30:00"]
        [<owner>.interval.early]
        start = 0.0
        end = 2.0
        num = 5
        [<owner>.window.late]
        start = 10.0
        end = 24.0
        paths = ["img_042.jpg"]
    """

    image_times: list = field(default_factory=list)
    image_intervals: dict = field(default_factory=dict)
    image_windows: dict = field(default_factory=dict)
    image_paths: list = field(default_factory=list)
    default_tol: float = 1.0 / 60.0

    def load(self, sec: dict) -> "TimeData":
        self.image_times = [
            convert_to_hours(t) for t in sec.get("times", [])
        ]
        for name, interval in sec.get("interval", {}).items():
            self.image_intervals[name] = TimeInterval.from_dict(interval)
        for name, window in sec.get("window", {}).items():
            self.image_windows[name] = TimeWindow.from_dict(window)
        self.image_paths = [Path(p) for p in sec.get("paths", [])]
        if "tol" in sec:
            self.default_tol = convert_to_hours(sec["tol"])
        return self

    def all_times(self) -> list:
        """All requested times (explicit + interval samples), sorted."""
        times = list(self.image_times)
        for interval in self.image_intervals.values():
            times.extend(interval.times())
        return sorted(set(times))

    def select(self, available_times: list) -> list:
        """Indices of available times matching this selection."""
        available = np.asarray(available_times, dtype=float)
        selected = set()
        for t in self.all_times():
            if available.size == 0:
                break
            idx = int(np.argmin(np.abs(available - t)))
            if abs(available[idx] - t) <= self.default_tol:
                selected.add(idx)
        for window in self.image_windows.values():
            selected.update(
                int(i)
                for i in np.nonzero(
                    (available >= window.start) & (available <= window.end)
                )[0]
            )
        if (
            not self.image_times
            and not self.image_intervals
            and not self.image_windows
            and not self.image_paths
        ):
            return list(range(len(available_times)))
        return sorted(selected)

    @property
    def empty(self) -> bool:
        return not (
            self.image_times
            or self.image_intervals
            or self.image_windows
            or self.image_paths
        )

    def get_times_with_uncertainty(self) -> list:
        """All requested (time, tol) pairs across the selection modes
        (reference time_data.py:253-300), sorted by time.  Intervals
        without an explicit tol inherit ``default_tol`` — consistent with
        how :meth:`select` matches their sample times."""
        pairs = [(t, self.default_tol) for t in self.image_times]
        for interval in self.image_intervals.values():
            tol = interval.tol if interval.tol is not None else self.default_tol
            pairs.extend((t, tol) for t in interval.generate_times())
        return sorted(pairs, key=lambda p: p[0])

    def error(self):
        raise ValueError(
            "Use key `data` within the considered subsection in the config "
            "file. Supported modes: time, interval, or path."
        )

    # Per-mode views (reference ``time_data.py:244-251`` stores these as
    # fields; the aggregate here materializes them on demand).

    @property
    def image_time_data(self) -> "ImageTimeData":
        view = ImageTimeData()
        view.times = sorted(self.image_times)
        view.times_with_tolerance = [
            (t, self.default_tol) for t in view.times
        ]
        return view

    @property
    def image_interval_data(self) -> "ImageTimeIntervalData":
        view = ImageTimeIntervalData()
        view.intervals = dict(self.image_intervals)
        view.windows = dict(self.image_windows)
        return view

    @property
    def image_path_data(self) -> "PathData":
        view = PathData()
        view.paths = list(self.image_paths)
        return view


@dataclass
class ImageTimeData:
    """Explicit image times view (reference ``time_data.py:78-122``).

    The aggregate :class:`TimeData` stores all selection modes in one
    object; this view exposes the reference's per-mode surface: ``load``
    parses only ``times``/``tol`` keys, and
    ``get_times_with_uncertainty`` returns ``(time, tol)`` pairs.
    """

    times: list = field(default_factory=list)
    times_with_tolerance: list = field(default_factory=list)

    def load(self, sec: dict) -> "ImageTimeData":
        tolerance = convert_to_hours(sec.get("tol", 0.0))
        self.times.extend(convert_to_hours(t) for t in sec.get("times", []))
        self.times.sort()
        self.times_with_tolerance = [(t, tolerance) for t in self.times]
        return self

    def get_times_with_uncertainty(self) -> list:
        return list(self.times_with_tolerance)


@dataclass
class ImageTimeIntervalData:
    """Interval/window selection view (reference ``time_data.py:125-166``)."""

    intervals: dict = field(default_factory=dict)
    windows: dict = field(default_factory=dict)

    def load(self, sec: dict) -> "ImageTimeIntervalData":
        for name, data in sec.get("interval", {}).items():
            if "num" in data or "step" in data:
                self.intervals[name] = TimeInterval.from_dict(data)
            else:
                self.windows[name] = TimeWindow.from_dict(data)
        for name, data in sec.get("window", {}).items():
            self.windows[name] = TimeWindow.from_dict(data)
        return self

    def get_times_with_uncertainty(self) -> list:
        all_times = []
        for interval in self.intervals.values():
            tol = interval.tol if interval.tol is not None else 0.0
            all_times.extend((t, tol) for t in interval.times())
        return all_times


@dataclass
class PathData:
    """Direct-file-path selection view (reference ``time_data.py:169-231``):
    entries with ``*`` glob inside the data folder(s), relative entries
    resolve against the first folder that contains them."""

    paths: list = field(default_factory=list)

    def load(self, sec: dict, data_folder=None) -> "PathData":
        raw = sec.get("paths", [])
        if isinstance(raw, str):
            raw = [raw]
        folders = (
            [Path(f) for f in data_folder]
            if isinstance(data_folder, (list, tuple))
            else ([Path(data_folder)] if data_folder is not None else [])
        )
        for entry in raw:
            entry = str(entry)
            if "*" in entry:
                for folder in folders or [Path(".")]:
                    self.paths.extend(sorted(folder.glob(entry)))
                continue
            candidate = Path(entry)
            if candidate.is_absolute() or not folders:
                self.paths.append(candidate)
                continue
            existing = [f / candidate for f in folders if (f / candidate).exists()]
            self.paths.extend(existing if existing else [folders[0] / candidate])
        self.paths = sorted(set(self.paths))
        return self

    def validate(self) -> bool:
        missing = [p for p in self.paths if not p.exists()]
        if missing:
            import logging

            logging.getLogger(__name__).warning(
                "Missing image paths: %s", missing
            )
            return False
        return True
