"""Named image-export format presets from [format.*].

Parity: reference ``presets/workflows/config/format_registry.py:18-160``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from .toml_utils import convert_none, get_section

__all__ = ["ImageExportFormat", "FormatRegistry", "SUPPORTED_EXPORT_FORMATS"]

SUPPORTED_EXPORT_FORMATS = {"jpg", "png", "npz", "npy", "csv"}
_NAME_TOKEN = re.compile(r"stem|hh|mm|ss|dd")


@dataclass
class ImageExportFormat:
    type: str
    identifier: str
    name: str = "stem"
    resolution: Optional[tuple] = None
    dpi: Optional[int] = None
    cmap: Optional[str] = None
    keep_ratio: bool = False
    dtype: Optional[str] = None
    quality: Optional[int] = None
    compression: Optional[int] = None
    delimiter: str = ","
    header: Optional[str] = None
    float_format: str = "{:.2e}"

    @property
    def folder_name(self) -> str:
        return self.identifier

    def render_name(self, stem: str, time_hours: Optional[float] = None) -> str:
        """Expand name tokens (stem, dd/hh/mm/ss from elapsed time)."""
        out = self.name.replace("stem", stem)
        if time_hours is not None:
            total_seconds = int(round(time_hours * 3600))
            dd, rem = divmod(total_seconds, 86400)
            hh, rem = divmod(rem, 3600)
            mm, ss = divmod(rem, 60)
            out = (
                out.replace("dd", f"{dd:02d}")
                .replace("hh", f"{hh:02d}")
                .replace("mm", f"{mm:02d}")
                .replace("ss", f"{ss:02d}")
            )
        return out


@dataclass
class FormatRegistry:
    _registry: dict = field(default_factory=dict)

    def load(self, path) -> "FormatRegistry":
        sec = get_section(path, "format")
        self._registry = {}
        for format_type, entries in sec.items():
            ftype = str(format_type).strip().lower()
            if ftype not in SUPPORTED_EXPORT_FORMATS:
                raise ValueError(
                    f"Unsupported format type {format_type!r}. "
                    f"Supported: {sorted(SUPPORTED_EXPORT_FORMATS)}"
                )
            for identifier, entry in entries.items():
                if identifier in self._registry:
                    raise ValueError(
                        f"Format identifier {identifier!r} duplicated."
                    )
                spec = ImageExportFormat(type=ftype, identifier=str(identifier))
                spec.name = str(entry.get("name", "stem")).strip()
                if _NAME_TOKEN.search(spec.name) is None:
                    raise ValueError(
                        f"name in [format.{ftype}.{identifier}] must contain "
                        "one of: stem, hh, mm, ss, dd."
                    )
                resolution = convert_none(entry.get("resolution"))
                if resolution is not None:
                    rows, cols = int(resolution[0]), int(resolution[1])
                    if rows <= 0 or cols <= 0:
                        raise ValueError("resolution entries must be positive.")
                    spec.resolution = (rows, cols)
                spec.keep_ratio = bool(entry.get("keep_ratio", False))
                if ftype in ("jpg", "png"):
                    for attr, caster, valid in (
                        ("dpi", int, None),
                        ("cmap", str, None),
                        ("quality", int, range(0, 101)),
                        ("compression", int, range(0, 10)),
                    ):
                        raw = convert_none(entry.get(attr))
                        if raw is not None:
                            value = caster(raw)
                            if valid is not None and value not in valid:
                                raise ValueError(
                                    f"{attr} in [format.{ftype}.{identifier}] "
                                    "out of range."
                                )
                            setattr(spec, attr, value)
                if ftype in ("npz", "npy", "csv"):
                    dtype = convert_none(entry.get("dtype"))
                    spec.dtype = None if dtype is None else str(dtype)
                if ftype == "csv":
                    spec.delimiter = str(entry.get("delimiter", ","))
                    spec.header = convert_none(entry.get("header"))
                    spec.float_format = str(
                        entry.get("float_format", "{:.2e}")
                    )
                self._registry[identifier] = spec
        return self

    def keys(self) -> list:
        return list(self._registry.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def __getitem__(self, key: str) -> ImageExportFormat:
        return self._registry[key]

    def resolve(self, keys) -> dict:
        if isinstance(keys, str):
            keys = [keys]
        missing = [k for k in keys if k not in self._registry]
        if missing:
            raise KeyError(
                f"Format keys {missing} not found. Available: {self.keys()}."
            )
        return {k: self._registry[k] for k in keys}
