"""TOML parsing helpers + declarative section loader.

Parity: reference ``presets/workflows/config/utils.py`` (helpers).  The
``SectionConfig`` base replaces the reference's hand-written per-key
``load`` bodies with a declarative ``_spec`` table.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional, Union

__all__ = [
    "deep_merge",
    "read_toml",
    "get_section",
    "get_key",
    "convert_to_hours",
    "convert_none",
    "validate_choice",
    "Key",
    "SectionConfig",
]


def deep_merge(base: dict, update: dict) -> dict:
    """Recursively merge ``update`` into ``base`` (in place)."""
    for key, value in update.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            deep_merge(base[key], value)
        else:
            base[key] = value
    return base


def read_toml(path: Union[Path, list]) -> dict:
    """Parse one TOML file or deep-merge a list of them."""
    if isinstance(path, (str, Path)):
        return tomllib.loads(Path(path).read_text())
    if isinstance(path, list):
        data: dict = {}
        for p in path:
            deep_merge(data, tomllib.loads(Path(p).read_text()))
        return data
    raise TypeError(f"Path must be a Path or list of Paths, got {type(path)}.")


def get_section(path_or_dict, section: str) -> dict:
    """Fetch a (possibly dotted) section from a TOML path/list/dict."""
    data = (
        path_or_dict
        if isinstance(path_or_dict, dict)
        else read_toml(path_or_dict)
    )
    for part in section.split("."):
        if part not in data:
            raise KeyError(f"Section {section} not found.")
        data = data[part]
    return data


def get_key(
    section: dict,
    key: str,
    default=None,
    required: bool = True,
    type_: Optional[Callable] = None,
) -> Any:
    if key not in section:
        if required:
            raise KeyError(f"Missing key '{key}' in section {section}.")
        return default
    value = section[key]
    return type_(value) if type_ else value


def convert_to_hours(time_value) -> float:
    """Float hours, or 'DD:HH:MM:SS' / 'HH:MM:SS' / 'HH:MM' / 'HH' strings."""
    if isinstance(time_value, (int, float)):
        return float(time_value)
    if isinstance(time_value, str):
        parts = [int(p) for p in time_value.split(":")]
        if len(parts) > 4 or not parts:
            raise ValueError(
                f"Invalid time format: {time_value}. "
                "Use DD:HH:MM:SS, HH:MM:SS, HH:MM, or HH."
            )
        if len(parts) == 4:
            days, hours, minutes, seconds = parts
        else:
            # Leading field is hours; pad minutes/seconds with zeros.
            days = 0
            hours, minutes, seconds = (parts + [0, 0])[:3]
        return (
            timedelta(
                days=days, hours=hours, minutes=minutes, seconds=seconds
            ).total_seconds()
            / 3600
        )
    raise ValueError(f"Invalid time value: {time_value}.")


def convert_none(value):
    if isinstance(value, str) and value.lower() == "none":
        return None
    return value


def validate_choice(value: str, *, allowed, context: str, key: str) -> str:
    if value not in allowed:
        raise ValueError(
            f"Invalid {context}.{key} '{value}'. Allowed: {sorted(allowed)}."
        )
    return value


@dataclass
class Key:
    """One entry of a SectionConfig spec."""

    name: str
    type_: Optional[Callable] = None
    required: bool = False
    choices: Optional[set] = None


class SectionConfig:
    """Declarative TOML section loader.

    Subclasses define ``_section`` (dotted TOML section name) and ``_spec``
    (list of Key entries whose names match dataclass fields); ``load``
    populates matching attributes and returns self.  Override ``_post_load``
    for derived fields.
    """

    _section: str = ""
    _spec: list = []

    def load(self, path, **context) -> "SectionConfig":
        sec = get_section(path, self._section)
        for entry in self._spec:
            value = get_key(
                sec,
                entry.name,
                default=getattr(self, entry.name, None),
                required=entry.required,
                type_=None,
            )
            if value is not None and entry.type_ is not None:
                value = entry.type_(value)
            if entry.choices is not None and value is not None:
                validate_choice(
                    str(value),
                    allowed=entry.choices,
                    context=self._section,
                    key=entry.name,
                )
            setattr(self, entry.name, value)
        self._post_load(sec, **context)
        return self

    def _post_load(self, sec: dict, **context) -> None:
        pass

    def error(self):
        raise ValueError(
            f"Use [{self._section}] in the config file to load this section."
        )
