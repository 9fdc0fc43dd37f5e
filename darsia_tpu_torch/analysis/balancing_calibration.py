"""Balancing calibration: continuity across facies boundaries.

Counterpart of :mod:`darsia_tpu.analysis.balancing_calibration`.  The
per-label scalings of the balancing model are fitted so the signal is
continuous across label boundaries: for each pair of touching labels, the
means of the signal on thin strips either side of their boundary.  The JAX
package dilates each label on the host (``scipy.ndimage.binary_dilation``,
the cross-shaped structure, ``boundary_width`` iterations) and means each
strip there.  Here the dilation is ``boundary_width`` cross-shaped passes
over all labels at once on the signal's device, and the strip sums of an
image are one weighted ``bincount`` per label, read to the host once per
image.  The log least-squares solve is numpy's, as there.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from ..image.image import as_numpy
from ..ops.morphology import dilate_cross
from ..signals.models.basemodel import LabelIndex

__all__ = [
    "AbstractBalancingCalibration",
    "ContinuityBasedBalancingCalibrationMixin",
]


class AbstractBalancingCalibration:
    """Calibration harness for the balancing model (mixin)."""

    @abc.abstractmethod
    def optimize_balancing(self, images, options: dict) -> np.ndarray:
        ...

    def update_balancing_for_calibration(self, parameters: np.ndarray, options: dict) -> None:
        dofs = options.get("balancing_dofs", None)
        self.balancing.update_model_parameters(parameters, dofs)

    def calibrate_balancing(self, images, options: dict) -> bool:
        """Calibrate the balancing model from images (a list or a series)."""
        if not isinstance(images, list):
            assert images.series
            series = images.copy()
            images = [series.time_slice(i) for i in range(series.time_num)]
        parameters = self.optimize_balancing(images, options)
        self.update_balancing_for_calibration(parameters, options)
        return True


class ContinuityBasedBalancingCalibrationMixin(AbstractBalancingCalibration):
    """Balance per-label scalings to make the signal continuous across
    facies boundaries."""

    def _boundary_strips(self, index: torch.Tensor, num: int, width: int) -> tuple:
        """(dilated, counts, touching): the (num, H, W) dilated label masks;
        counts[b, a], the number of label a's pixels inside the dilation of
        label b (label a's strip at its boundary with b); and the label
        pairs (a, b), a < b, whose dilations reach each other."""
        labels = torch.arange(num, device=index.device)[:, None, None]
        dilated = dilate_cross(index[None] == labels, width)
        counts = as_numpy(torch.stack([torch.bincount(index[d], minlength=num) for d in dilated]))
        touching = [(a, b) for a in range(num) for b in range(a + 1, num) if counts[a, b] > 0]
        return dilated, counts, touching

    def optimize_balancing(self, images, options: dict) -> np.ndarray:
        """Closed-form log-least-squares for the per-label scalings.

        For each boundary pair (a, b): scaling_a * mean_a = scaling_b *
        mean_b; in log space a linear system over the log-scalings with the
        gauge log s_0 = 0.
        """
        label_index = LabelIndex(options["labels"])
        width = options.get("boundary_width", 3)
        n = len(label_index)

        signals = [self._reduce_signal(self._subtract_background(img)) for img in images]
        index = label_index.on(signals[0].device)
        dilated, counts, touching = self._boundary_strips(index, n, width)

        rows, rhs = [], []
        for signal in signals:
            values = signal.to(torch.float64)
            # sums[b, a]: the signal summed over label a's strip at its
            # boundary with b.
            sums = as_numpy(
                torch.stack(
                    [torch.bincount(index[d], weights=values[d], minlength=n) for d in dilated]
                )
            )
            for a, b in touching:
                mean_a = sums[b, a] / counts[b, a] if counts[b, a] else 0.0
                mean_b = sums[a, b] / counts[a, b] if counts[a, b] else 0.0
                if mean_a <= 1e-12 or mean_b <= 1e-12:
                    continue
                row = np.zeros(n)
                row[a] = 1.0
                row[b] = -1.0
                rows.append(row)
                rhs.append(np.log(mean_b) - np.log(mean_a))
        # Gauge: the first label keeps scaling 1.
        gauge = np.zeros(n)
        gauge[0] = 1.0
        rows.append(gauge)
        rhs.append(0.0)
        log_s, *_ = np.linalg.lstsq(np.stack(rows), np.asarray(rhs), rcond=None)
        return np.exp(log_s)
