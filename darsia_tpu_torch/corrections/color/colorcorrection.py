"""Classic color-checker (Macbeth) color correction.

Counterpart of :mod:`darsia_tpu.corrections.color.colorcorrection`.  Per
image, on the frame's device: cut the checker out (a box by slicing and
rotating, a quadrilateral by the warp), warp the crop to the checker's
aspect ratio (the warp: K1 on CUDA, as on the TPU) and resize it to 500 px
wide.  Only that resized crop is copied to the host, where the 24 swatch
colors are extracted (the JAX package's dominant-color k-means, same seeds)
and the balance is fitted in float64 numpy; the balance is applied to the
frame on the device.  The JAX package reads the whole frame to the host
first; the result is the same.
"""

from __future__ import annotations

import copy
import json
from abc import ABC
from pathlib import Path
from typing import Literal, Optional
from warnings import warn

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from ...ops.color import lab_to_rgb
from ...ops.polynomial_color import colour_correction
from ...ops.resize import resize_array
from ...utils.dtype import convert_dtype
from ...utils.kmeans import dominant_color
from ...utils.npz import load_npz
from ...utils.optional import optional_module
from ...utils.point import VoxelArray, make_voxel
from ..base import BaseCorrection
from ..shape.quad import extract_quadrilateral_ROI
from .colorbalance import AdaptiveBalance

__all__ = [
    "ClassicColorChecker",
    "ColorChecker",
    "ColorCheckerAfter2014",
    "ColorCorrection",
    "CustomColorChecker",
]

# X-Rite/Calibrite ColorChecker Classic (post-Nov-2014) reference swatches in
# CIELAB (D50 per manufacturer specification; public constants), ordered
# column by column starting at the brown ("dark skin") swatch.
_XRITE_LAB_POST2014 = np.array(
    [
        [37.54, 14.37, 14.92],
        [62.73, 35.83, 56.5],
        [28.37, 15.42, -49.8],
        [95.19, -1.03, 2.93],
        [64.66, 19.27, 17.5],
        [39.43, 10.75, -45.17],
        [54.38, -39.72, 32.27],
        [81.29, -0.57, 0.44],
        [49.32, -3.82, -22.54],
        [50.57, 48.64, 16.67],
        [42.43, 51.05, 28.62],
        [66.89, -0.75, -0.06],
        [43.46, -12.74, 22.72],
        [30.1, 22.54, -20.87],
        [81.8, 2.67, 80.41],
        [50.76, -0.13, 0.14],
        [54.94, 9.61, -24.79],
        [71.77, -24.13, 58.19],
        [50.63, 51.28, -14.12],
        [35.63, -0.46, -0.48],
        [70.48, -32.26, -0.37],
        [71.51, 18.24, 67.37],
        [49.57, -29.71, -28.32],
        [20.64, 0.07, -0.46],
    ],
    dtype=np.float32,
)

# BabelColor average CIELAB values for the pre-Nov-2014 classic checker
# (public constants), row-major 4x6 starting at "dark skin".
_BABELCOLOR_LAB_CLASSIC = np.array(
    [
        [[37.99, 13.56, 14.06], [65.71, 18.13, 17.81], [49.93, -4.88, -21.93],
         [43.14, -13.10, 21.91], [55.11, 8.84, -25.40], [70.72, -33.40, -0.20]],
        [[62.66, 36.07, 57.10], [40.02, 10.41, -45.96], [51.12, 48.24, 16.25],
         [30.33, 22.98, -21.59], [72.53, -23.71, 57.26], [71.94, 19.36, 67.86]],
        [[28.78, 14.18, -50.30], [55.26, -38.34, 31.37], [42.10, 53.38, 28.19],
         [81.73, 4.04, 79.82], [51.94, 49.99, -14.57], [51.04, -28.63, -28.64]],
        [[96.54, -0.43, 1.19], [81.26, -0.64, -0.34], [66.77, -0.73, -0.50],
         [50.87, -0.15, -0.27], [35.66, -0.42, -1.23], [20.46, -0.08, -0.97]],
    ],
    dtype=np.float32,
)

#: Physical size (mm) of the classic checker: the swatch grid's aspect ratio.
_CHECKER_WIDTH, _CHECKER_HEIGHT = 27.3, 17.8


def _lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    return lab_to_rgb(torch.from_numpy(np.ascontiguousarray(lab))).numpy().astype(np.float32)


class ColorChecker(ABC):
    """Base class of color checkers (4x6 swatch grid in RGB)."""

    _reference_swatches_rgb: np.ndarray

    @property
    def swatches_rgb(self):
        return self._reference_swatches_rgb

    @property
    def swatches_RGB(self):
        return (self._reference_swatches_rgb * 255).astype(np.uint8)

    def plot(self) -> None:
        """Show the 4x6 swatches (host data; needs matplotlib)."""
        plt = optional_module("matplotlib.pyplot", "ColorChecker.plot")
        _, ax = plt.subplots()
        ax.imshow(self._reference_swatches_rgb)
        ax.set_title("Color checker")
        plt.show()

    def save(self, path: Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.save(path, self._reference_swatches_rgb)


class ColorCheckerAfter2014(ColorChecker):
    """The classic X-Rite checker with post-2014 reference colors."""

    def __init__(self) -> None:
        self._reference_swatches_rgb = _lab_to_rgb(
            _XRITE_LAB_POST2014.reshape((4, 6, 3), order="F")
        )


class ClassicColorChecker(ColorChecker):
    """The classic X-Rite checker with pre-Nov-2014 reference colors."""

    def __init__(self) -> None:
        self._reference_swatches_rgb = _lab_to_rgb(_BABELCOLOR_LAB_CLASSIC)


class CustomColorChecker(ColorChecker):
    """Swatch colors given, extracted from a checker image, or loaded."""

    def __init__(
        self,
        reference_colors: Optional[np.ndarray] = None,
        image=None,
        path: Optional[Path] = None,
    ) -> None:
        provided = [reference_colors is not None, image is not None, path is not None]
        if np.count_nonzero(provided) != 1:
            raise ValueError("Provide exactly one of: reference_colors, image, path.")
        if reference_colors is not None:
            self._reference_swatches_rgb = np.array(reference_colors, copy=True)
        elif image is not None:
            self._reference_swatches_rgb = self._extract_from_image(image)
        else:
            self._reference_swatches_rgb = np.load(path)

    @staticmethod
    def _extract_from_image(img) -> np.ndarray:
        """The 4x6 dominant swatch colors of a checker crop (a tensor, or a
        numpy array, which goes to the card).  The crop is shaped on its
        device; only the resized crop is read to the host, for the k-means."""
        crop = convert_dtype(as_tensor(img), torch.float32)
        # The physical checker's aspect ratio, then a fixed width.
        crop = extract_quadrilateral_ROI(crop, pts_src=None, width=_CHECKER_WIDTH, height=_CHECKER_HEIGHT)
        Ny, Nx = crop.shape[:2]
        fixed_width = 500
        resized = resize_array(crop, (int(Ny / Nx * fixed_width), fixed_width), "inter_linear")
        resized = as_numpy(resized)

        swatch_pos_row, swatch_pos_col = np.meshgrid(
            [12, 93, 175, 255], [12, 95, 177, 260, 344, 427], indexing="ij"
        )
        swatch_size = 50
        swatches = np.zeros((4, 6, 3), dtype=np.float32)
        for row in range(4):
            for col in range(6):
                pr, pc = swatch_pos_row[row, col], swatch_pos_col[row, col]
                pixels = resized[pr : pr + swatch_size, pc : pc + swatch_size]
                swatches[row, col] = dominant_color(pixels.reshape(-1, 3), num_clusters=5)
        return swatches


class ColorCorrection(BaseCorrection):
    """Color correction anchored at a color checker in the image.

    Args:
        base: reference checker (an Image or tensor containing one, a
            ColorChecker, or None for the classic post-2014 checker).
        config: ``roi`` (4 corner voxels of the checker, starting at the
            brown swatch, counter-clockwise), ``balancing`` ("darsia" or
            "colour"), ``whitebalancing``, ``colorbalancing`` ("affine" or
            "linear"), ``clip``, ``active``.

    """

    def __init__(self, base=None, config: Optional[dict] = None) -> None:
        if config is not None:
            self.config: dict = copy.deepcopy(config)
            self._init_from_config(base)
        else:
            self.config = {}
            self.active = False

    def _init_from_config(self, base) -> None:
        self.active: bool = self.config.get("active", True)
        self.whitebalancing: bool = self.config.get("whitebalancing", True)
        self.colorbalancing: Literal["affine", "linear"] = self.config.get(
            "colorbalancing", "affine"
        )
        self.verbosity: bool = self.config.get("verbosity", False)
        roi = self.config.get("roi")
        if roi is None:
            raise ValueError("Provide ROI for color correction.")
        self.roi: VoxelArray = make_voxel(np.asarray(roi))
        self.balancing: Literal["colour", "darsia"] = self.config.get("balancing", "darsia")
        self.clip: bool = self.config.get("clip", False)
        if base is None:
            base = self.config.get("colorchecker", None)
        self._setup_colorchecker(base)

    def _setup_colorchecker(self, base) -> None:
        if base is None:
            self.colorchecker: ColorChecker = ColorCheckerAfter2014()
        elif isinstance(base, ColorChecker):
            self.colorchecker = base
        else:
            data = base.img if hasattr(base, "img") else base
            self.colorchecker = CustomColorChecker(image=self._restrict_to_roi(data))

    def _restrict_to_roi(self, img):
        """The (reoriented) checker region of an image (a tensor, or a numpy
        array, which goes to the card), on its device."""
        img = as_tensor(img)
        roi = np.asarray(self.roi)
        row_pixels = np.sort(roi[:, 0])
        col_pixels = np.sort(roi[:, 1])
        row_diff = max(row_pixels[1] - row_pixels[0], row_pixels[3] - row_pixels[2])
        col_diff = max(col_pixels[1] - col_pixels[0], col_pixels[3] - col_pixels[2])
        H, W = img.shape[:2]
        if row_diff < 0.01 * H and col_diff < 0.01 * W:
            box = img[row_pixels[0] : row_pixels[3], col_pixels[0] : col_pixels[3]]
            first = roi[0]
            atol = max(0.01 * H, 0.01 * W)
            # np.rot90's turns, brown swatch to the top-left.
            for corner, turns in (
                ((row_pixels[0], col_pixels[0]), 0),
                ((row_pixels[0], col_pixels[3]), 1),
                ((row_pixels[3], col_pixels[3]), -2),
                ((row_pixels[3], col_pixels[0]), -1),
            ):
                if np.allclose(corner, first, atol=atol):
                    return torch.rot90(box, turns, dims=(0, 1)) if turns else box
            raise ValueError("The brown sample is not in a corner of the ROI.")
        return extract_quadrilateral_ROI(
            img, pts_src=self.roi, width=_CHECKER_WIDTH, height=_CHECKER_HEIGHT, indexing="matrix"
        )

    def _swatches(self, img: torch.Tensor) -> np.ndarray:
        """The 4x6 swatch colors of the checker in ``img`` (host, float32)."""
        return CustomColorChecker(image=self._restrict_to_roi(img)).swatches_rgb

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        img = convert_dtype(img, torch.float32)
        if not self.active:
            return img
        swatches = self._swatches(img)
        reference_swatches = self.colorchecker.swatches_rgb

        if self.balancing == "colour":
            ref_flat = reference_swatches.reshape((24, 3), order="F")
            sw_flat = swatches.reshape((24, 3), order="F")
            if self.colorbalancing == "affine":
                warn("Affine color balancing not available in 'colour' mode.")
            corrected = colour_correction(img, sw_flat, ref_flat)
            if self.whitebalancing:
                # The neutral swatch (row 3 of the column-major listing).
                pos = 11
                sw2_flat = self._swatches(corrected).reshape((24, 3), order="F")
                ratio = np.asarray(ref_flat[pos], np.float32) / np.asarray(sw2_flat[pos], np.float32)
                corrected = corrected * torch.from_numpy(ratio).to(corrected.device)
        elif self.balancing == "darsia":
            # White balance on the 6-swatch neutral bottom row, color balance
            # on the 18 chromatic swatches of the first three rows.
            balance = AdaptiveBalance()
            if self.whitebalancing:
                balance.find_balance(
                    swatches[-1].reshape(-1, 3),
                    reference_swatches[-1].reshape(-1, 3),
                    mode="diagonal",
                )
            balance.find_balance(
                swatches[:-1].reshape(-1, 3),
                reference_swatches[:-1].reshape(-1, 3),
                mode="affine" if self.colorbalancing == "affine" else "linear",
            )
            corrected = balance.apply_balance(img)
        else:
            raise ValueError(f"balancing {self.balancing} not supported.")

        if self.clip:
            corrected = corrected.clamp(0.0, 1.0)
        return corrected.to(torch.float32)

    # ------------------------------------------------------------------ I/O

    def write_config_to_file(self, path) -> None:
        cfg = json.loads(json.dumps(self.config, default=lambda o: np.asarray(o).tolist()))
        with open(Path(path), "w") as f:
            json.dump(cfg, f, indent=4)

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        cfg = dict(self.config)
        cfg["roi"] = np.asarray(self.roi)
        np.savez(
            path,
            class_name=type(self).__name__,
            base=self.colorchecker._reference_swatches_rgb,
            config=np.array([cfg], dtype=object),
        )

    def load(self, path) -> None:
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"File {path} does not exist.")
        data = load_npz(path)
        self.config = data["config"][0]
        self._init_from_config(base=CustomColorChecker(reference_colors=data["base"]))
