"""Relative (spatially varying polynomial) color correction.

Counterpart of :mod:`darsia_tpu.corrections.color.relativecolorcorrection`.
A per-pixel 3x3 color matrix, whose entries vary over the image as a
polynomial in the coordinates (LinearApproximation), calibrated from sets of
"similar colors" sampled across calibration images.  The calibration is a
closed-form float64 least-squares solve on the host; the field is evaluated
once over the baseline's grid, on the baseline's device, and kept there as
float32 (9 values per pixel); the correction is a per-pixel matrix-vector
product on the image's device.

Samples are given explicitly (lists of slice tuples) or, without them,
picked by hand with :class:`~darsia_tpu_torch.assistants.BoxSelectionAssistant`
(matplotlib and a display; headless it raises).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...utils.approximations import LinearApproximation, PolynomialApproximationSpace
from ...utils.extractcharacteristicdata import extract_characteristic_data
from ...utils.npz import load_npz
from ..base import BaseCorrection

__all__ = ["RelativeColorCorrection"]


def _samples(samples, img, config: dict) -> list:
    """``samples``, or boxes of ``config["sample_size"]`` (50) picked by hand
    on ``img``."""
    if samples is not None:
        return samples
    from ...assistants import BoxSelectionAssistant

    return BoxSelectionAssistant(img, width=config.get("sample_size", 50))()


class RelativeColorCorrection(BaseCorrection):
    """Heterogeneous polynomial color correction."""

    def __init__(self, baseline=None, images=None, config: Optional[dict] = None) -> None:
        self.baseline = baseline
        self.calibration_images = (
            [images] if images is not None and hasattr(images, "img") else images
        )
        self.config = config if config is not None else {}
        self.correction = self.define_correction()
        self.data: list[tuple[np.ndarray, np.ndarray]] = []
        self.reference_data: list[np.ndarray] = []
        self._evaluated: Optional[torch.Tensor] = None

    def define_correction(self) -> LinearApproximation:
        ansatz = self.config.get("method", "polynomial")
        if ansatz != "polynomial":
            raise ValueError(f"Ansatz {ansatz!r} is not supported.")
        degree = self.config.get("degree", 2)
        space = PolynomialApproximationSpace(degree)
        return LinearApproximation(space, (3, 3), domain="coordinates")

    # ------------------------------------------------------------ calibration

    def add_calibration_data(
        self,
        coordinates: np.ndarray,
        colors: np.ndarray,
        reference_color: np.ndarray,
    ) -> None:
        """Register a group of similar colors and their reference.

        Args:
            coordinates: (N, 2) physical coordinates of the samples.
            colors: (N, 3) observed colors at those positions.
            reference_color: (3,) color they all should map to.

        """
        self.data.append((np.asarray(coordinates, float), np.asarray(colors, float)))
        self.reference_data.append(np.asarray(reference_color, float))

    @staticmethod
    def _sample_centers_and_colors(img, samples):
        """(centers (N, 2) voxels, characteristic colors (N, 3)); only the
        sample patches are read to the host."""
        mid = lambda s: int(0.5 * (s.start + s.stop))  # noqa: E731
        centers = np.array([[mid(s[0]), mid(s[1])] for s in samples])
        colors = extract_characteristic_data(signal=img.img, samples=samples)
        return centers, np.asarray(colors)

    def define_similar_colors(self, samples_per_image=None) -> None:
        """Collect groups of similar colors across the calibration images:
        ``samples_per_image[k]`` lists the sample boxes of image ``k``."""
        cs = self.calibration_images[0].coordinatesystem
        for k, img in enumerate(self.calibration_images):
            samples = _samples(None if samples_per_image is None else samples_per_image[k], img, self.config)
            centers, colors = self._sample_centers_and_colors(img, samples)
            coords = np.asarray(cs.coordinate(centers), dtype=float)
            self.data.append((coords, np.asarray(colors, float)))

    def define_reference_color(self, samples=None) -> None:
        """The reference color: the first sample of the first calibration
        image."""
        samples = _samples(samples, self.calibration_images[0], self.config)
        if len(samples) == 0:
            raise ValueError("No samples selected.")
        _, colors = self._sample_centers_and_colors(self.calibration_images[0], samples[:1])
        self.reference_data.append(np.asarray(colors[0], float))

    def define_similar_and_reference_colors_tensorial(
        self, reference_samples=None, location_samples=None
    ) -> None:
        """Two-stage tensorial sampling: a grid of distinct colors on one
        checker and the same grid repeated across the image; the stage-1
        colors serve as references."""
        img = self.calibration_images[0]
        reference_samples = _samples(reference_samples, img, self.config)
        location_samples = _samples(location_samples, img, self.config)
        ref_centers, ref_colors = self._sample_centers_and_colors(img, reference_samples)
        loc_centers, _ = self._sample_centers_and_colors(img, location_samples)
        # Tensorial fill-in: each reference color is observed at every
        # location, displaced by the checker-internal offset.
        cs = img.coordinatesystem
        origin = ref_centers[0]
        data = img.img
        upper = np.asarray(data.shape[:2]) - 1
        for ref_center, ref_color in zip(ref_centers, ref_colors):
            voxels = np.clip(loc_centers + (ref_center - origin)[None, :], 0, upper).astype(int)
            rows = torch.from_numpy(voxels[:, 0]).to(data.device)
            cols = torch.from_numpy(voxels[:, 1]).to(data.device)
            colors = data[rows, cols, :].cpu().numpy()
            coords = np.asarray(cs.coordinate(voxels), dtype=float)
            self.data.append((coords, np.asarray(colors, float)))
            self.reference_data.append(np.asarray(ref_color, float))

    def calibrate(self) -> None:
        """LS-fit the polynomial coefficients of the 3x3 correction field.

        For each sample: basis(coord)_i * C_i @ color = reference, linear in
        the stacked coefficients C.
        """
        if not self.data:
            raise ValueError("No calibration data provided.")
        space = self.correction.space
        rows = []
        rhs = []
        for (coords, colors), ref in zip(self.data, self.reference_data):
            basis = np.stack([space.basis(coords, i) for i in range(space.size)], axis=1)
            for n in range(coords.shape[0]):
                # Output channel r: sum_i b_i * C[i][r, :] @ color = ref[r].
                for r in range(3):
                    row = np.zeros((space.size, 3, 3))
                    row[:, r, :] = np.outer(basis[n], colors[n])
                    rows.append(row.ravel())
                    rhs.append(ref[r])
        sol, *_ = np.linalg.lstsq(np.stack(rows), np.asarray(rhs), rcond=None)
        self.correction.coefficients = sol.reshape(self.correction.shape)

    def setup(self) -> None:
        """Evaluate the correction field over the baseline's grid, on the
        baseline's device (cached)."""
        if self.baseline is None:
            raise ValueError("Baseline image required for setup.")
        self._evaluated = self.correction.evaluate_on(
            self.baseline.coordinatesystem, self.baseline.img.device
        )

    # ------------------------------------------------------------ correction

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        if self._evaluated is None:
            raise ValueError("Call setup() before correcting (it needs the baseline).")
        if self._evaluated.device != img.device:
            self._evaluated = self._evaluated.to(img.device)
        # out[i, j, k] = sum_l field[i, j, k, l] * img[i, j, l]
        return (self._evaluated * img.to(torch.float32)[..., None, :]).sum(dim=-1)

    # ------------------------------------------------------------------ I/O

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            class_name=type(self).__name__,
            coefficients=self.correction.coefficients,
            config=np.array([self.config], dtype=object),
        )

    def load(self, path) -> None:
        """Coefficients and config from a file.  The file holds no baseline:
        a correction read back by ``read_correction`` corrects only once
        ``baseline`` is set and ``setup()`` has run, as in the JAX package."""
        data = load_npz(path)
        self.config = data["config"][0]
        self.correction = self.define_correction()
        self.correction.coefficients = data["coefficients"]
        if self.baseline is not None:
            self.setup()
