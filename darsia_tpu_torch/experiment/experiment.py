"""Protocolled experiments: image discovery by time since injection start.

Counterpart of :mod:`darsia_tpu.experiment.experiment` (reference
``src/darsia/experiment/experiment.py``); the protocols are this package's
(:mod:`.protocols`, no pandas).  ``data=None`` (a run's config read without
its data folder, as the cross-run comparison reads it) is an empty list:
the JAX package iterates it and fails (ROADMAP.md Queue 3, reference fault
24).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np

from .protocols import (
    ImagingProtocol,
    InjectionProtocol,
    PressureTemperatureProtocol,
)

__all__ = ["Experiment", "TimeWindow", "ProtocolledExperiment"]


@dataclass
class TimeWindow:
    """Time window in hours since experiment start."""

    start: float
    end: float


class Experiment(ABC):
    """Abstract experiment interface (reference
    ``experiment/experiment.py:17-36``: atmospheric pressure, temperature
    and the injection window are the abstract physical state every
    concrete experiment must expose)."""

    @property
    @abstractmethod
    def atmospheric_pressure(self):
        ...

    @property
    @abstractmethod
    def temperature(self):
        ...

    @property
    @abstractmethod
    def injection_start(self) -> datetime:
        ...

    @property
    @abstractmethod
    def injection_end(self) -> datetime:
        ...

    def hours_since_start(self, date: datetime) -> float:
        return (date - self.injection_start).total_seconds() / 3600


class ProtocolledExperiment:
    """Experiment defined by CSV protocols (imaging/injection/PT)."""

    def __init__(
        self,
        data: list,
        imaging_protocol,
        injection_protocol=None,
        pressure_temperature_protocol=None,
        blacklist_protocol=None,
        pad: int = 5,
    ) -> None:
        self.data = [Path(p) for p in data or []]
        if isinstance(imaging_protocol, dict):
            self.imaging_protocol = None
            self.imaging_protocols = {
                Path(folder): ImagingProtocol(protocol, pad, blacklist_protocol)
                for folder, protocol in imaging_protocol.items()
            }
            self._folders = sorted(
                self.imaging_protocols.items(),
                key=lambda item: len(item[0].parts),
                reverse=True,
            )
        else:
            self.imaging_protocol = ImagingProtocol(
                imaging_protocol, pad, blacklist_protocol
            )
            self.imaging_protocols = None
            self._folders = []
        self.injection_protocol = (
            InjectionProtocol(injection_protocol)
            if injection_protocol is not None
            else None
        )
        self.pressure_temperature_protocol = (
            PressureTemperatureProtocol(pressure_temperature_protocol)
            if pressure_temperature_protocol is not None
            else None
        )
        if self.injection_protocol is not None:
            self.experiment_start = min(self.injection_protocol.df["start"])
        else:
            # Fall back to the earliest protocolled image.
            protocols = (
                [self.imaging_protocol]
                if self.imaging_protocol
                else list(self.imaging_protocols.values())
            )
            self.experiment_start = min(
                min(p.datetime_by_image_id.values()) for p in protocols
            )

    @classmethod
    def init_from_config(cls, config):
        """Build from a FluidFlowerConfig (any object with its ``data`` and
        ``protocol`` sections)."""
        if config.data is None or config.protocol is None:
            raise ValueError("The config needs its data and protocol sections.")
        return cls(
            data=config.data.data,
            imaging_protocol=config.protocol.imaging,
            injection_protocol=config.protocol.injection,
            pressure_temperature_protocol=config.protocol.pressure_temperature,
            blacklist_protocol=config.protocol.blacklist,
            pad=config.data.pad,
        )

    # ------------------------------------------------------------ protocols

    def _protocol_for_path(self, path: Path) -> ImagingProtocol:
        if self.imaging_protocol is not None:
            return self.imaging_protocol
        for folder, protocol in self._folders:
            try:
                Path(path).relative_to(folder)
                return protocol
            except ValueError:
                continue
        raise ValueError(f"No imaging protocol covers {path}.")

    def get_datetime(self, path: Path) -> datetime:
        return self._protocol_for_path(path).get_datetime(path)

    def is_blacklisted(self, path: Path) -> bool:
        return self._protocol_for_path(path).is_blacklisted(path)

    def time_since_start(self, date: datetime) -> float:
        """Hours since experiment start."""
        return (date - self.experiment_start).total_seconds() / 3600

    # ------------------------------------------------------------ discovery

    def _timeline(self, paths: list) -> tuple[list, list]:
        seconds, valid = [], []
        for p in paths:
            try:
                if self.is_blacklisted(p):
                    continue
                dt = self.get_datetime(p)
            except (ValueError, KeyError):
                continue
            seconds.append((dt - self.experiment_start).total_seconds())
            valid.append(p)
        order = np.argsort(seconds)
        return [seconds[i] for i in order], [valid[i] for i in order]

    def iter_available(self, paths: list) -> list:
        """Usable images as (index, path, datetime) tuples — not
        blacklisted, with a resolvable protocol datetime (reference
        experiment.py:279-292)."""
        available = []
        for idx, path in enumerate(paths):
            try:
                if self.is_blacklisted(path):
                    continue
                date = self.get_datetime(path)
            except (ValueError, KeyError):
                continue
            if date is None:
                continue
            available.append((idx, path, date))
        return available

    def find_images_for_paths(self, paths: list) -> list:
        return [p for p in paths if not self.is_blacklisted(p)]

    def find_images_for_time_windows(
        self, windows: list, data: Optional[list] = None
    ) -> list:
        """All protocolled images within the given hour windows."""
        seconds, paths = self._timeline(data or self.data)
        if not paths:
            raise ValueError("No available images found in the specified paths.")
        selected = []
        for window in windows:
            lo, hi = window.start * 3600, window.end * 3600
            selected.extend(
                p for s, p in zip(seconds, paths) if lo <= s <= hi
            )
        unique = list(dict.fromkeys(selected))
        unique.sort(key=self.get_datetime)
        return unique

    def find_images_for_times(
        self,
        times,
        tol: Optional[float] = None,
        data: Optional[list] = None,
    ):
        """Closest image(s) to given hours since start (tol in seconds)."""
        is_list = isinstance(times, list)
        req = times if is_list else [times]
        seconds, paths = self._timeline(data or self.data)
        if not paths:
            raise ValueError("No available images found in the specified paths.")
        selected = []
        for t in req:
            target = t * 3600
            idx = int(np.argmin(np.abs(np.asarray(seconds) - target)))
            if tol is None or abs(seconds[idx] - target) <= tol:
                selected.append(paths[idx])
        unique = list(dict.fromkeys(selected))
        if is_list:
            return unique
        return unique[0] if unique else None
