"""Local illumination (white-balance) correction.

Counterpart of :mod:`darsia_tpu.corrections.color.illuminationcorrection`.
Setup (host, as in the JAX package): sample patches across the baseline,
extract a characteristic color per patch (k-means; only the patches are
copied from the device), fit per-sample scaling factors that harmonize the
colors within each sample group (scipy L-BFGS-B on the same quadratic
objective, through the interpolation's hat matrix), and interpolate them to
a full-resolution scaling field on the baseline's device.  Correction is a
multiply by that field on the image's device.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from ...image.image import ScalarImage, as_numpy
from ...ops.color import convert_trichromatic, rgb_to_gray
from ...utils.dtype import convert_dtype
from ...utils.extractcharacteristicdata import extract_characteristic_data
from ...utils.interpolation import interpolate_to_image, polynomial_design_matrix
from ...utils.npz import load_npz
from ...utils.point import make_voxel
from ..base import BaseCorrection

logger = logging.getLogger(__name__)

__all__ = ["IlluminationCorrection"]

_DEGREES = {"linear": 1, "quadratic": 2, "cubic": 3, "quartic": 4}


class IlluminationCorrection(BaseCorrection):
    """Spatially varying white balance fit from image samples."""

    # ------------------------------------------------------------- sampling

    def select_random_samples(self, mask, config) -> list[tuple[slice, ...]]:
        """Random square patches within the masked region.

        Args:
            mask: boolean image, tensor or array of eligible pixels.
            config: object with ``width``, ``num_samples`` and ``seed``
                (e.g. the rig's illumination config).

        """
        # The global numpy RNG, seeded, as the JAX package draws.
        np.random.seed(config.seed)
        width = config.width
        mask_arr = as_numpy(mask.img if hasattr(mask, "img") else mask)

        larger_mask = np.zeros((mask_arr.shape[0] + width, mask_arr.shape[1] + width), dtype=bool)
        larger_mask[: mask_arr.shape[0], : mask_arr.shape[1]] = mask_arr
        indices = np.nonzero(mask_arr)
        valid = larger_mask[tuple(idx + width for idx in indices)]
        restricted = tuple(idx[valid] for idx in indices)

        num_eligible = len(restricted[0])
        if num_eligible == 0:
            logger.warning("No eligible points for sampling found.")
            return []
        random_ids = np.unique((np.random.rand(config.num_samples) * num_eligible).astype(int))
        sample_indices = np.transpose(tuple(idx[random_ids] for idx in restricted))
        return [(slice(s[0], s[0] + width), slice(s[1], s[1] + width)) for s in sample_indices]

    # ---------------------------------------------------------------- setup

    def setup(
        self,
        base,
        sample_groups: list[list[tuple[slice, ...]]],
        mask=None,
        outliers: float = 0.0,
        filter: callable = lambda x: x,
        colorspace: Literal[
            "rgb", "rgb-scalar", "lab", "lab-scalar", "hsl", "hsl-scalar", "gray"
        ] = "hsl-scalar",
        interpolation: Literal["rbf", "quartic", "illumination"] = "quartic",
        bounds: tuple[float, float] = (0.5, 2.0),
        show_plot: bool = False,
        log: Optional[Path] = None,
    ) -> None:
        """Fit the local scaling field from sample groups on base image(s)."""
        from scipy.optimize import minimize

        if hasattr(base, "img"):
            base = [base]
        self.colorspace = colorspace.lower()
        images = self._convert_images(base)

        characteristic_colors = {
            (g, i): extract_characteristic_data(
                signal=image, mask=mask, samples=samples, filter=filter
            )
            for g, samples in enumerate(sample_groups)
            for i, image in enumerate(images)
        }
        active_groups = [
            g
            for g in range(len(sample_groups))
            if sum(len(characteristic_colors[(g, i)]) for i in range(len(images))) > 0
        ]
        num_samples = [len(sample_groups[g]) for g in active_groups]
        color_components = 3 if self.colorspace in ("rgb", "lab", "hsl") else 1

        mid_voxels = make_voxel(
            np.array(
                [
                    [(s[0].start + s[0].stop) // 2, (s[1].start + s[1].stop) // 2]
                    for g in active_groups
                    for s in sample_groups[g]
                ]
            )
        )
        self._mid_coordinates = np.asarray(base[0].coordinatesystem.coordinate(mid_voxels))
        self._interpolation = interpolation

        # The interpolation evaluated back at the sample centers is linear in
        # the nodal values: its hat matrix.
        n = len(mid_voxels)
        if interpolation in _DEGREES:
            degree = _DEGREES[interpolation]
            while degree > 0 and (degree + 1) * (degree + 2) // 2 > n:
                degree -= 1
            X = polynomial_design_matrix(self._mid_coordinates, degree)
            hat = X @ np.linalg.pinv(X)
        else:
            # Exact interpolants reproduce the nodal values.
            hat = np.eye(n)

        def objective(scaling: np.ndarray) -> float:
            s = scaling.reshape(-1, color_components)
            eff = hat @ s
            residual = 0.0
            offset = 0
            for gi, g in enumerate(active_groups):
                ns = num_samples[gi]
                block = slice(offset, offset + ns)
                for image_id in range(len(images)):
                    colors = characteristic_colors[(g, image_id)]
                    if len(colors) == 0:
                        continue
                    colors = np.asarray(colors).reshape(ns, color_components)
                    avg = (eff[block] * colors).mean(axis=0)
                    local = (s[block] * colors - avg) ** 2
                    sorted_res = np.sort(local, axis=0)
                    trim = int(outliers * sorted_res.shape[0])
                    if trim == 0:
                        residual += float(np.sum(sorted_res))
                    else:
                        residual += float(np.sum(sorted_res[trim:-trim]))
                offset += ns
            return residual

        num_vars = sum(num_samples) * color_components
        result = minimize(
            objective,
            np.ones(num_vars),
            bounds=[bounds] * num_vars,
            method="L-BFGS-B",
            tol=1e-6,
            options={"maxiter": 1000, "ftol": 1e-10, "gtol": 1e-8},
        )
        scaling = result.x.reshape(-1, color_components)
        self.local_scaling = self._interpolate_scaling(scaling, base[0], interpolation)
        self._scaling_cache: dict = {}

    def _interpolate_scaling(self, scaling_values, base_image, interpolation):
        x = self._mid_coordinates[:, 0]
        y = self._mid_coordinates[:, 1]
        template = ScalarImage(
            torch.zeros(tuple(base_image.num_voxels[:2]), device=base_image.device),
            dimensions=list(base_image.dimensions),
            origin=np.asarray(base_image.origin),
        )
        if self.colorspace == "rgb":
            columns = range(3)
        else:
            component = {"lab": 0, "hsl": 1}.get(self.colorspace, 0)
            columns = [component if scaling_values.shape[1] > 1 else 0]
        return [
            interpolate_to_image((x, y, scaling_values[:, i]), template, method=interpolation)
            for i in columns
        ]

    def _convert_images(self, base_images: list) -> list[torch.Tensor]:
        """The baselines in the working colorspace, on their devices."""
        out = []
        for base in base_images:
            arr = convert_dtype(base.img, torch.float32)
            space = self.colorspace
            if space in ("rgb", "rgb-scalar"):
                out.append(arr)
            elif space in ("lab", "lab-scalar"):
                lab = convert_trichromatic(arr, "RGB", "LAB")
                out.append(lab if space == "lab" else lab[..., 0])
            elif space in ("hsl", "hsl-scalar"):
                hls = convert_trichromatic(arr, "RGB", "HLS")
                out.append(hls if space == "hsl" else hls[..., 1])
            elif space == "gray":
                out.append(rgb_to_gray(arr))
            else:
                raise ValueError("Invalid colorspace; choose rgb/lab/hsl(-scalar)/gray.")
        return out

    # ----------------------------------------------------------- correction

    def _scaling(self, device) -> torch.Tensor:
        """The scaling field, (H, W, 3) or (H, W, 1), on ``device`` (cached)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_scaling_cache", {})
        if device not in cache:
            fields = [s.img.to(device=device, dtype=torch.float32) for s in self.local_scaling]
            cache[device] = torch.stack(fields, dim=-1)
        return cache[device]

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        if img.shape[-1] == 1:
            raise NotImplementedError("Only color images are supported.")
        if not hasattr(self, "local_scaling"):
            logger.info("No local scaling determined; returning original image.")
            return img
        if img.shape[-1] != 3:
            raise ValueError("Only trichromatic images are supported.")
        return img * self._scaling(img.device)

    # ------------------------------------------------------------------ I/O

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            class_name=type(self).__name__,
            colorspace=self.colorspace,
            scaling_arrays=np.stack([as_numpy(s.img) for s in self.local_scaling]),
            dimensions=np.asarray(self.local_scaling[0].dimensions),
        )

    def load(self, path: Path) -> None:
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"File {path} not found.")
        data = load_npz(path)
        self.colorspace = str(data["colorspace"])
        arrays = data["scaling_arrays"]
        dims = [float(d) for d in data["dimensions"]]
        # CPU tensors; each moves to an image's device once, when it is used.
        self.local_scaling = [
            ScalarImage(torch.from_numpy(np.ascontiguousarray(a)), dimensions=dims)
            for a in arrays
        ]
        self._scaling_cache = {}
