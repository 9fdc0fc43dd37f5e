"""Thermodynamic flash: signal -> (gas saturation, aqueous concentration).

Counterpart of :mod:`darsia_tpu.multiphase.flash`; the maps stay on their
device.  ``SimpleFlash`` files are the JAX package's npz (``class_name``,
``values``), read through :func:`~darsia_tpu_torch.utils.npz.load_npz`.
"""

from __future__ import annotations

from pathlib import Path
from warnings import warn

import numpy as np
import torch

from ..utils.npz import load_npz

__all__ = ["AdvancedFlash", "Flash", "SimpleFlash"]


def _like(image, data: torch.Tensor):
    """An image with ``image``'s metadata and the given data."""
    return type(image)(img=data, **image.metadata())


class Flash:
    """Partition normalized concentrations into phase quantities."""

    def __init__(self, s_g_max: float = 1.0, s_g_cutoff: float = 0.0) -> None:
        self.s_g_max = s_g_max
        self.s_g_cutoff = s_g_cutoff

    def __call__(self, c_g, c_aq):
        """Flash of (gas, aqueous) concentration maps.

        Returns:
            (chi_g, chi_aq, s_g, s_aq): volumetric concentrations and
            saturations per phase.

        """
        cg = c_g.img.to(torch.float32)
        caq = c_aq.img.to(torch.float32)
        # Two scalar reads, as the JAX package makes them.
        if float(cg.max()) > 1 + 1e-6:
            warn("Concentration of CO2 in gas phase has to be normalized.")
        if float(caq.max()) > 1 + 1e-6:
            warn("Concentration of CO2 in aqueous phase has to be normalized.")
        s_g_arr = self.s_g_max * cg.clamp(0.0, 1.0)
        cutoff = cg < self.s_g_cutoff
        s_g_arr = torch.where(cutoff, 0.0, s_g_arr)
        s_aq_arr = 1.0 - s_g_arr
        chi_aq_arr = torch.where(cutoff, s_aq_arr * caq, s_aq_arr)
        return (
            _like(c_g, s_g_arr),
            _like(c_g, chi_aq_arr),
            _like(c_g, s_g_arr),
            _like(c_g, s_aq_arr),
        )


class AdvancedFlash(Flash):
    """Flash with post-restoration of all outputs."""

    def __init__(self, s_g_max=1.0, s_g_cutoff=0.0, restoration=None) -> None:
        super().__init__(s_g_max, s_g_cutoff)
        self.restoration = restoration

    def __call__(self, c_g, c_aq):
        outputs = super().__call__(c_g, c_aq)
        if self.restoration is None:
            return outputs
        return tuple(self.restoration(out) for out in outputs)


class SimpleFlash:
    """Interval-based flash from a single signal, with save/load.

    Signal in [min_value_aq, max_value_aq] maps to aqueous concentration in
    [0, 1]; [min_value_g, max_value_g] maps to gas saturation in [0, 1].
    """

    def __init__(
        self,
        min_value_aq: float,
        max_value_aq: float,
        min_value_g: float,
        max_value_g: float,
        restoration=None,
    ) -> None:
        self.min_value_aq = min_value_aq
        self.max_value_aq = max_value_aq
        self.min_value_g = min_value_g
        self.max_value_g = max_value_g
        self.restoration = restoration

    def __call__(self, signal):
        data = signal.img.to(torch.float32)
        c_aq_arr = (
            (data - self.min_value_aq) / max(self.max_value_aq - self.min_value_aq, 1e-12)
        ).clamp(0.0, 1.0)
        s_g_arr = (
            (data - self.min_value_g) / max(self.max_value_g - self.min_value_g, 1e-12)
        ).clamp(0.0, 1.0)
        c_aq, s_g = _like(signal, c_aq_arr), _like(signal, s_g_arr)
        if self.restoration is not None:
            c_aq = self.restoration(c_aq)
            s_g = self.restoration(s_g)
        return c_aq, s_g

    def update(self, min_value_aq=None, max_value_aq=None, min_value_g=None, max_value_g=None):
        """Update the flash bounds."""
        if min_value_aq is not None:
            self.min_value_aq = float(min_value_aq)
        if max_value_aq is not None:
            self.max_value_aq = float(max_value_aq)
        if min_value_g is not None:
            self.min_value_g = float(min_value_g)
        if max_value_g is not None:
            self.max_value_g = float(max_value_g)

    def to_dict(self) -> dict:
        return {
            "min_value_aq": self.min_value_aq,
            "max_value_aq": self.max_value_aq,
            "min_value_g": self.min_value_g,
            "max_value_g": self.max_value_g,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "SimpleFlash":
        return cls(
            min_value_aq=data["min_value_aq"],
            max_value_aq=data.get("max_value_aq"),
            min_value_g=data.get("min_value_g"),
            max_value_g=data.get("max_value_g"),
        )

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            class_name=type(self).__name__,
            values=np.array(
                [self.min_value_aq, self.max_value_aq, self.min_value_g, self.max_value_g]
            ),
        )

    def load(self, path) -> None:
        values = load_npz(Path(path), names=("values",))["values"]
        (
            self.min_value_aq,
            self.max_value_aq,
            self.min_value_g,
            self.max_value_g,
        ) = [float(v) for v in values]
