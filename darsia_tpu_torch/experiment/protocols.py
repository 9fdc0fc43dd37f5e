"""CSV-backed experiment protocols: imaging, injection, pressure/temperature.

Counterpart of :mod:`darsia_tpu.experiment.protocols` (reference
``src/darsia/experiment/protocols.py``), without pandas: a protocol file is
read with the ``csv`` module into a :class:`ProtocolTable` (the JAX
package's ``.df``), and datetimes are parsed as ISO 8601 (``T`` or a space
between date and time, no time zone), the forms the protocols use.  An
``.xls``/``.xlsx`` sheet is read by pandas (imported when called) into the
same table, its datetimes as datetimes.

CSV schemas (columns):
* imaging: ``image_id, datetime[, path]``; blacklist: ``image_id``.
* injection: ``location_x, location_y, start, end, rate_kg_s`` (or
  ``rate_kg/s``, ``rate_sccm``, ``rate_ml/min``).
* pressure/temperature: ``datetime, pressure, temperature`` (or
  ``pressure_bar``, ``temperature_celsius``).
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.csv_table import read_excel_columns

__all__ = [
    "ImagingInterval",
    "ImagingProtocol",
    "ImagingProtocolOld",
    "InjectionProtocol",
    "PressureTemperatureProtocol",
    "ProtocolTable",
    "ThermodynamicState",
]


class ProtocolTable:
    """A protocol file's columns by name, in file order: each a list of its
    cells (strings, ``""`` where a cell is empty, until a protocol parses
    a column)."""

    def __init__(self, columns: dict) -> None:
        self.data = dict(columns)

    @property
    def columns(self) -> list:
        return list(self.data)

    def __contains__(self, name) -> bool:
        return name in self.data

    def __getitem__(self, name) -> list:
        return self.data[name]

    def __setitem__(self, name, values) -> None:
        self.data[name] = list(values)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()), []))


def _load_table(path) -> ProtocolTable:
    if isinstance(path, (list, tuple)):
        protocol_path, sheet = Path(path[0]), path[1]
    else:
        protocol_path, sheet = Path(path), None
    if protocol_path.suffix == ".csv":
        if sheet is not None:
            raise ValueError("Sheet name only applies to Excel files.")
        with open(protocol_path, newline="") as f:
            rows = [row for row in csv.reader(f) if row]
        header, body = rows[0], rows[1:]
        return ProtocolTable(
            {
                name: [row[i] if i < len(row) else "" for row in body]
                for i, name in enumerate(header)
            }
        )
    if protocol_path.suffix in (".xls", ".xlsx"):
        return ProtocolTable(read_excel_columns(protocol_path, sheet, "reading Excel protocols"))
    raise ValueError(f"Unsupported protocol format {protocol_path.suffix}.")


def _normalize_injection_columns(table: ProtocolTable) -> ProtocolTable:
    """Normalize injection-rate columns onto ``rate_kg_s``.

    Accepts the reference template variants: ``rate_kg/s`` (rename),
    ``rate_sccm`` / ``rate_ml/min`` (converted with CO2 density at
    standard conditions, 1.98 kg/m^3 — reference protocols.py:527-556).
    """
    if "rate_kg_s" in table:
        return table
    if "rate_kg/s" in table:
        return ProtocolTable(
            {("rate_kg_s" if k == "rate_kg/s" else k): v for k, v in table.data.items()}
        )
    density_co2 = 1.98  # kg/m^3 at standard conditions
    for name in ("rate_sccm", "rate_ml/min"):
        if name in table:
            table["rate_kg_s"] = [float(v) * density_co2 * 1e-6 / 60.0 for v in table[name]]
            return table
    raise ValueError(
        "Injection protocol needs one of: rate_kg_s, rate_kg/s, rate_sccm, "
        "rate_ml/min."
    )


def _parse_datetime(value) -> datetime:
    """A datetime from a protocol cell: ISO 8601 with ``T`` or a space
    between date and time (what ``pd.to_datetime`` gives for these)."""
    if isinstance(value, datetime):
        return value
    text = str(value).strip()
    try:
        return datetime.fromisoformat(text)
    except ValueError as exc:
        raise ValueError(
            f"Datetime {text!r} is not ISO 8601 (YYYY-MM-DD[ HH:MM[:SS[.ffffff]]])."
        ) from exc


def _epoch_seconds(date: datetime) -> float:
    """Seconds since the epoch, a naive datetime read as UTC (as pandas'
    ``Timestamp.timestamp`` reads it)."""
    if date.tzinfo is None:
        date = date.replace(tzinfo=timezone.utc)
    return date.timestamp()


def _is_missing(cell) -> bool:
    return cell is None or str(cell).strip() == "" or str(cell).lower() in ("nan", "none")


@dataclass
class ImagingInterval:
    """Regular imaging interval: ids [start_id, end_id] at fixed dt."""

    start_id: int
    end_id: int
    start_datetime: datetime
    dt_seconds: float

    def contains(self, image_id: int) -> bool:
        return self.start_id <= image_id <= self.end_id

    def get_datetime(self, image_id: int) -> datetime:
        if not self.contains(image_id):
            raise ValueError(f"Image id {image_id} outside the interval.")
        return self.start_datetime + timedelta(
            seconds=(image_id - self.start_id) * self.dt_seconds
        )


class ImagingProtocol:
    """Image id/path -> acquisition datetime, with blacklisting."""

    def __init__(self, path, pad: int, blacklist=None) -> None:
        self.df = _load_table(path)
        self.pad = pad
        blacklist_ids = _load_table(blacklist)["image_id"] if blacklist is not None else []
        self.blacklist_ids: set[int] = {int(float(v)) for v in blacklist_ids}

        self.datetime_by_image_id: dict[int, datetime] = {}
        for image_id, dt in zip(self.df["image_id"], self.df["datetime"]):
            key = int(float(image_id))
            if key not in self.datetime_by_image_id:
                self.datetime_by_image_id[key] = _parse_datetime(dt)

        self.datetime_by_path_key: dict[str, datetime] = {}
        if "path" in self.df:
            for p, dt in zip(self.df["path"], self.df["datetime"]):
                if _is_missing(p):
                    continue
                self.datetime_by_path_key.setdefault(self._normalize(str(p)), _parse_datetime(dt))

    @staticmethod
    def _normalize(path: str) -> str:
        return str(path).replace("\\", "/").lstrip("./")

    def image_id(self, path: Path) -> int:
        try:
            return int(Path(path).stem[-self.pad :])
        except ValueError as exc:
            raise ValueError(f"Invalid image id in file name: {Path(path).stem}") from exc

    def is_blacklisted(self, file_name: Path) -> bool:
        if not self.blacklist_ids:
            return False
        return self.image_id(file_name) in self.blacklist_ids

    def _candidates(self, file_name: Path) -> tuple[str, ...]:
        file_name = Path(file_name)
        two_level = (
            "/".join(file_name.parts[-2:]) if len(file_name.parts) >= 2 else file_name.name
        )
        return (
            self._normalize(file_name.name),
            self._normalize(file_name.as_posix()),
            self._normalize(two_level),
        )

    def get_datetime(self, file_name: Path) -> Optional[datetime]:
        for key in self._candidates(file_name):
            dt = self.datetime_by_path_key.get(key)
            if dt is not None:
                return dt
        current_id = self.image_id(file_name)
        dt = self.datetime_by_image_id.get(current_id)
        if dt is None:
            raise ValueError(f"Image id {current_id} not found in protocol.")
        return dt

    def find_images_for_paths(self, paths: list) -> list:
        """Filter paths: keep protocolled, non-blacklisted images."""
        out = []
        for p in paths:
            try:
                if self.is_blacklisted(p):
                    continue
                self.get_datetime(p)
                out.append(p)
            except (ValueError, KeyError):
                continue
        return out

    def find_images_for_datetimes(
        self, paths: list, datetimes: list, tolerance_seconds: float = np.inf
    ) -> list:
        """For each target datetime, the closest protocolled image path."""
        valid = self.find_images_for_paths(paths)
        image_times = [self.get_datetime(p) for p in valid]
        out = []
        for target in datetimes:
            target = _parse_datetime(target)
            deltas = [abs((t - target).total_seconds()) for t in image_times]
            if not deltas:
                out.append(None)
                continue
            best = int(np.argmin(deltas))
            out.append(valid[best] if deltas[best] <= tolerance_seconds else None)
        return out

    find_ideal_images_for_datetimes = find_images_for_datetimes


class InjectionProtocol:
    """Injection intervals -> cumulative injected mass."""

    def __init__(self, path) -> None:
        self.df = _normalize_injection_columns(_load_table(path))
        for col in ("start", "end"):
            self.df[col] = [_parse_datetime(v) for v in self.df[col]]
        self.num_injections = len(self.df)

    def injected_mass(
        self,
        date: Optional[datetime] = None,
        time: Optional[float] = None,
        roi=None,
    ) -> float:
        """Cumulative injected mass [kg] until date (or time in hours)."""
        if (date is None) == (time is None):
            raise ValueError("Provide exactly one of date or time.")
        mass = 0.0
        for i in range(self.num_injections):
            if roi is not None:
                loc = np.array([float(self.df["location_x"][i]), float(self.df["location_y"][i])])
                roi_arr = np.asarray(roi)
                lo = roi_arr.min(axis=0)
                hi = roi_arr.max(axis=0)
                if not (lo[0] <= loc[0] <= hi[0] and lo[1] <= loc[1] <= hi[1]):
                    continue
            start = self.df["start"][i]
            end = self.df["end"][i]
            rate = float(self.df["rate_kg_s"][i])
            if date is not None:
                if date <= start:
                    passed = 0.0
                elif date < end:
                    passed = (date - start).total_seconds()
                else:
                    passed = (end - start).total_seconds()
            else:
                passed = float(np.clip(time * 3600.0, 0.0, (end - start).total_seconds()))
            mass += passed * rate
        return mass


@dataclass
class ThermodynamicState:
    """Pressure [bar-ish, protocol units] and temperature [deg C]."""

    pressure: float
    temperature: float


class PressureTemperatureProtocol:
    """Time-interpolated pressure/temperature states."""

    def __init__(self, path) -> None:
        table = _load_table(path)
        table["datetime"] = [_parse_datetime(v) for v in table["datetime"]]
        order = sorted(range(len(table)), key=lambda i: table["datetime"][i])
        self.df = ProtocolTable({k: [v[i] for i in order] for k, v in table.data.items()})
        # Accept the reference template column names as aliases.
        if "pressure" not in self.df and "pressure_bar" in self.df:
            self.df["pressure"] = self.df["pressure_bar"]
        if "temperature" not in self.df and "temperature_celsius" in self.df:
            self.df["temperature"] = self.df["temperature_celsius"]
        self._times = np.array([_epoch_seconds(t) for t in self.df["datetime"]])
        self._pressure = np.array([float(v) for v in self.df["pressure"]])
        self._temperature = np.array([float(v) for v in self.df["temperature"]])

    def get_state(self, date: datetime) -> ThermodynamicState:
        t = _epoch_seconds(date)
        pressure = float(np.interp(t, self._times, self._pressure))
        temperature = float(np.interp(t, self._times, self._temperature))
        return ThermodynamicState(pressure=pressure, temperature=temperature)

    def get_gradient(self, date: datetime, dt_seconds: float = 60.0):
        t = _epoch_seconds(date)
        p1 = np.interp(t + dt_seconds, self._times, self._pressure)
        p0 = np.interp(t - dt_seconds, self._times, self._pressure)
        t1 = np.interp(t + dt_seconds, self._times, self._temperature)
        t0 = np.interp(t - dt_seconds, self._times, self._temperature)
        return ThermodynamicState(
            pressure=float((p1 - p0) / (2 * dt_seconds)),
            temperature=float((t1 - t0) / (2 * dt_seconds)),
        )


class ImagingProtocolOld:
    """Interval-based imaging protocol (legacy format): trailing image-id
    digits in file names map onto datetimes through ordered
    :class:`ImagingInterval` entries; saved to and loaded from JSON."""

    def __init__(self, intervals: Optional[list] = None, pad: int = 5) -> None:
        self.intervals = intervals or []
        self.pad = pad

    def get_datetime(self, file_name: Path) -> Optional[datetime]:
        current_id = int(Path(file_name).stem[-self.pad :])
        interval = None
        for candidate in self.intervals:
            if candidate.contains(current_id):
                interval = candidate
            else:
                break  # intervals are chronologically ordered
        return interval.get_datetime(current_id) if interval else None

    def save(self, file_name: Path) -> None:
        data = {
            "pad": self.pad,
            "intervals": [
                {
                    "start_id": i.start_id,
                    "end_id": i.end_id,
                    "start_datetime": i.start_datetime.isoformat(),
                    "dt_seconds": i.dt_seconds,
                }
                for i in self.intervals
            ],
        }
        Path(file_name).write_text(json.dumps(data, indent=2))

    @classmethod
    def load(cls, file_name: Path) -> "ImagingProtocolOld":
        data = json.loads(Path(file_name).read_text())
        intervals = [
            ImagingInterval(
                start_id=int(entry["start_id"]),
                end_id=int(entry["end_id"]),
                start_datetime=datetime.fromisoformat(entry["start_datetime"]),
                dt_seconds=float(entry["dt_seconds"]),
            )
            for entry in data["intervals"]
        ]
        return cls(intervals=intervals, pad=int(data["pad"]))
