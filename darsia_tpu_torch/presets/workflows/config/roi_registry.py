"""Named ROI registry from the top-level [roi.*] TOML section.

Parity: reference ``presets/workflows/config/roi_registry.py:12-120``.
"""

from __future__ import annotations

from .roi import RoiAndLabelConfig, RoiAndSubroiConfig, RoiConfig
from .toml_utils import get_section

__all__ = ["RoiRegistry"]


class RoiRegistry:
    """Auto-typed ROI entries: label -> RoiAndLabelConfig, subroi ->
    RoiAndSubroiConfig, else RoiConfig."""

    def __init__(self) -> None:
        self._registry: dict = {}

    def load(self, path) -> "RoiRegistry":
        sec = get_section(path, "roi")
        self._registry = {}
        for key, entry in sec.items():
            if "label" in entry:
                self._registry[key] = RoiAndLabelConfig().load(entry)
            elif "subroi" in entry:
                self._registry[key] = RoiAndSubroiConfig().load(entry)
            else:
                self._registry[key] = RoiConfig().load(entry)
        return self

    def register(self, key: str, roi) -> None:
        if key in self._registry:
            raise KeyError(f"ROI key {key!r} is already registered.")
        self._registry[key] = roi

    def keys(self) -> list:
        return list(self._registry.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def __getitem__(self, key: str):
        return self._registry[key]

    def resolve(self, keys) -> dict:
        if isinstance(keys, str):
            keys = [keys]
        missing = [k for k in keys if k not in self._registry]
        if missing:
            raise KeyError(
                f"ROI keys {missing} not found. Available: {self.keys()}."
            )
        return {k: self._registry[k] for k in keys}

    def resolve_rois(self, keys) -> dict:
        """Resolve plain ROI entries (reference roi_registry.py API)."""
        resolved = self.resolve(keys)
        for key, entry in resolved.items():
            if isinstance(entry, RoiAndLabelConfig):
                raise TypeError(f"ROI key {key!r} is a labeled ROI.")
        return resolved

    def resolve_roi_and_labels(self, keys) -> dict:
        resolved = self.resolve(keys)
        for key, entry in resolved.items():
            if not isinstance(entry, RoiAndLabelConfig):
                raise TypeError(f"ROI key {key!r} is not a labeled ROI.")
        return resolved
