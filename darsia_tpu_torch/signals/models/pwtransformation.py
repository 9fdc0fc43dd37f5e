"""Monotone piecewise-linear transformation of a scalar signal.

Counterpart of :mod:`darsia_tpu.signals.models.pwtransformation`: evaluated
with :func:`~darsia_tpu_torch.ops.interp.interp` on the signal's device
(supports and values copied there once, again when they change).  ``save``
and ``load`` write and read the JAX package's CSV (a ``supports,values``
header, one row per node) with the ``csv`` module: no pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional
from warnings import warn

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from ...ops.interp import interp
from ...utils.optional import agg_pyplot

__all__ = ["PWTransformation", "read_csv"]


def read_csv(path) -> tuple:
    """(supports, values) of a transformation's CSV file (float64 arrays)."""
    with open(Path(path).with_suffix(".csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    return (
        np.array([float(r["supports"]) for r in rows]),
        np.array([float(r["values"]) for r in rows]),
    )


class PWTransformation:
    """Piecewise-linear transformation with enforced monotonicity."""

    def __init__(self, supports=None, values=None) -> None:
        self.supports = None if supports is None else np.asarray(supports, float)
        self.values = None if values is None else np.asarray(values, float)
        self._on_device: dict = {}
        if supports is not None and values is not None:
            self.update(supports, values)

    def update(self, supports=None, values=None, dofs=None) -> None:
        if supports is not None:
            supports = np.asarray(supports, dtype=float)
            if dofs is not None:
                self.supports[np.asarray(dofs)] = supports
            else:
                self.supports = supports
        if values is not None:
            values = np.asarray(values, dtype=float)
            if dofs is not None:
                self.values[np.asarray(dofs)] = values
            else:
                self.values = values
        if self.supports is None or self.values is None:
            warn("No supports or values provided. Interpolator not updated.")
            return
        assert len(self.values) == len(self.supports), (
            f"wrong size: {len(self.values)} vs. {len(self.supports)}"
        )
        diff = np.diff(self.values)
        assert np.all(diff > -1e-12), f"monotonicity broken {diff}"

    def values_from_diff(self, values_diff) -> np.ndarray:
        """Node values from segment increments: ``[0, cumsum(diff)]``."""
        return np.hstack(([0.0], np.cumsum(np.asarray(values_diff, float))))

    def __call__(self, img):
        assert self.supports is not None and self.values is not None, "Interpolator not set."
        if hasattr(img, "img"):
            out = img.copy()
            out.img = self._call_for_array(img.img)
            return out
        return self._call_for_array(as_tensor(img))

    # Model-protocol alias (usable inside HeterogeneousModel).
    def call_array(self, arr):
        return self._call_for_array(as_tensor(arr))

    def _nodes(self, device) -> tuple:
        """(supports, values) as float32 tensors on ``device``."""
        supports = np.asarray(self.supports, dtype=np.float32)
        values = np.asarray(self.values, dtype=np.float32)
        fingerprint = supports.tobytes() + values.tobytes()
        held = self._on_device.get(device)
        if held is None or held[0] != fingerprint:
            nodes = (torch.from_numpy(supports).to(device), torch.from_numpy(values).to(device))
            held = self._on_device[device] = (fingerprint, nodes)
        return held[1]

    def _call_for_array(self, arr: torch.Tensor) -> torch.Tensor:
        return interp(arr.to(torch.float32), *self._nodes(arr.device))

    def inverse(self, value):
        """Inverse transformation (extrapolating linearly outside), on the
        host in float64, as in the JAX package."""
        values = np.asarray(self.values, float)
        supports = np.asarray(self.supports, float)
        value = np.asarray(as_numpy(value), float)
        out = np.interp(value, values, supports)
        if values[-1] > values[0]:
            lo_slope = (supports[1] - supports[0]) / max(values[1] - values[0], 1e-12)
            hi_slope = (supports[-1] - supports[-2]) / max(values[-1] - values[-2], 1e-12)
            out = np.where(value < values[0], supports[0] + (value - values[0]) * lo_slope, out)
            out = np.where(value > values[-1], supports[-1] + (value - values[-1]) * hi_slope, out)
        return out if out.ndim else float(out)

    def save(self, path: Path) -> None:
        """Write ``path`` (suffix .csv) as the JAX package writes it (pandas,
        no index): a ``supports,values`` header, then one row per node."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path.with_suffix(".csv"), "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["supports", "values"])
            for s, v in zip(self.supports, self.values):
                writer.writerow([repr(float(s)), repr(float(v))])

    @classmethod
    def load(cls, path: Path) -> "PWTransformation":
        supports, values = read_csv(path)
        return cls(supports=supports, values=values)

    def log(self, log: Optional[Path]) -> None:
        """Plot the transformation over its supports to the file ``log``."""
        if not log:
            return
        plt = agg_pyplot("PWTransformation.log")

        x = np.linspace(float(self.supports[0]), float(self.supports[-1]), 1000)
        plt.figure()
        plt.plot(x, as_numpy(self._call_for_array(torch.from_numpy(x))))
        plt.xlabel("Signal")
        plt.ylabel("Converted signal")
        plt.savefig(log)
        plt.close()
