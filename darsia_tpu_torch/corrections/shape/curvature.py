"""Curvature correction: crop + bulge + stretch polynomial warps.

Counterpart of :mod:`darsia_tpu.corrections.shape.curvature`.  The correction
is a coordinate-field generator: the pull-back grid is computed once per
input shape and device by pushing the identity coordinate images through the
configured steps (init -> crop -> bulge -> stretch), so the whole correction
costs one resampling pass per image.  The tuning helpers (``pre_bulge_
correction``, ``crop``, ``bulge_correction``, ``stretch_correction``) set one
step each and apply it to a tuning image; ``show_image`` draws it with
matplotlib (imported when called).

Config (dict, ``.json`` file, or the ``[curvature]`` section of a ``.toml``):

* ``init`` / ``bulge``: horizontal/vertical_bulge, *_center_offset
* ``crop``: pts_src (4 corner voxels, (row, col), TL-BL-BR-TR), width, height
* ``stretch``: horizontal/vertical_stretch, *_center_offset
"""

from __future__ import annotations

import json
import math
import threading
from pathlib import Path
from typing import Optional, Union
from warnings import warn

import numpy as np
import torch

from ...image.image import Image, as_numpy, as_tensor
from ...ops.warp import identity_grid, warp_backend
from ...utils.npz import load_npz
from ...utils.optional import optional_module
from ...utils.point import make_voxel
from ..base import BaseCorrection
from .quad import extract_quadrilateral_ROI

__all__ = [
    "CurvatureCorrection",
    "load_curvature_correction_config_from_dict",
    "load_curvature_correction_config_from_toml",
]

_BULGE_KEYS = {
    "horizontal_bulge": 0.0,
    "horizontal_center_offset": 0,
    "vertical_bulge": 0.0,
    "vertical_center_offset": 0,
}
_STRETCH_KEYS = {
    "horizontal_stretch": 0.0,
    "horizontal_center_offset": 0,
    "vertical_stretch": 0.0,
    "vertical_center_offset": 0,
}

#: Guards the lazily built pull-back grids: threads that read through one
#: correction together (``utils/prefetch.py``) build its grid once.
_GRID_LOCK = threading.RLock()


def load_curvature_correction_config_from_dict(sec: dict) -> dict:
    """Normalize a curvature config dict (see the module docstring)."""
    config: dict = {}
    for key, defaults in (("init", _BULGE_KEYS), ("bulge", _BULGE_KEYS)):
        if sec.get(key) is not None:
            config[key] = {k: sec[key].get(k, d) for k, d in defaults.items()}
    if sec.get("crop") is not None:
        config["crop"] = {
            # Corner voxels (row, col), floored as the JAX package's
            # VoxelArray holds them.
            "pts_src": make_voxel(sec["crop"].get("pts_src", [])),
            "width": sec["crop"].get("width", 1.0),
            "height": sec["crop"].get("height", 1.0),
        }
    if sec.get("stretch") is not None:
        config["stretch"] = {
            k: sec["stretch"].get(k, d) for k, d in _STRETCH_KEYS.items()
        }
    return config


def load_curvature_correction_config_from_toml(path) -> dict:
    """The curvature config of the ``[curvature]`` section of a toml file
    (empty, with a warning, where the file has none)."""
    import tomllib

    path = Path(path)
    data = tomllib.loads(path.read_text())
    if "curvature" not in data:
        warn(f"No 'curvature' section found in {path}.")
        return {}
    return load_curvature_correction_config_from_dict(data["curvature"])


def _read_config_file(path: Path) -> dict:
    if path.suffix == ".json":
        return load_curvature_correction_config_from_dict(json.loads(path.read_text()))
    if path.suffix == ".toml":
        return load_curvature_correction_config_from_toml(path)
    raise ValueError(f"Unsupported config file {path}.")


class CurvatureCorrection(BaseCorrection):
    """Polynomial curvature correction (crop/bulge/stretch)."""

    def __init__(
        self, config: Union[dict, str, Path, list, None] = None, **kwargs
    ) -> None:
        """
        Args:
            config: dict, ``.json``/``.toml`` path, or a list of paths.
            **kwargs: ``image`` (a tuning image: a tensor, a numpy array or
                the path of an ``.npz``/``.npy`` file, which goes to
                ``device``; other files raise naming their decoder, as
                ``imread`` does), ``width``, ``height``, ``in_meters``,
                ``resize_factor`` (rescales the config for a resized input),
                ``interpolation_order``, ``device``.

        """
        self.setup_config(config)
        if "image" in kwargs:
            source = kwargs["image"]
            if isinstance(source, (str, Path)):
                from ...image.imread import imread

                source = imread(source, device=kwargs.get("device")).img
            self.reference_image = as_tensor(source, kwargs.get("device"))
            self.current_image = self.reference_image.clone()
            self.in_meters = kwargs.get("in_meters", True)
            self.width = kwargs.get("width", 1.0)
            self.height = kwargs.get("height", 1.0)
        self.resize_factor = kwargs.get("resize_factor", 1.0)
        if not math.isclose(self.resize_factor, 1.0):
            self._adapt_config()
        self.interpolation_order: int = kwargs.get("interpolation_order", 1)
        self.cache: dict = {}
        self._fusion_version = 0

    # -------------------------------------------------------------- config

    def setup_config(self, config=None) -> None:
        if config is None:
            self.config = {}
        elif isinstance(config, dict):
            self.config = load_curvature_correction_config_from_dict(config)
        elif isinstance(config, (str, Path)):
            self.config = _read_config_file(Path(config))
        elif isinstance(config, list):
            self.config = {}
            for p in config:
                self.config.update(_read_config_file(Path(p)))
        else:
            raise ValueError("Unsupported config type.")

    def write_config_to_file(self, path) -> None:
        cfg = json.loads(json.dumps(self.config, default=lambda o: np.asarray(o).tolist()))
        with open(Path(path), "w") as outfile:
            json.dump(cfg, outfile, indent=4)

    def read_config_from_file(self, path) -> None:
        with open(Path(path), "r") as f:
            self.config = load_curvature_correction_config_from_dict(json.load(f))

    def _adapt_config(self) -> None:
        """Rescale the config for a resized input (``resize_factor``)."""
        for mainkey in ("init", "bulge"):
            if mainkey in self.config:
                for key in _BULGE_KEYS:
                    self.config[mainkey][key] *= self.resize_factor
        if "crop" in self.config:
            self.config["crop"]["pts_src"] = make_voxel(
                self.resize_factor * np.asarray(self.config["crop"]["pts_src"])
            )
        if "stretch" in self.config:
            for key in _STRETCH_KEYS:
                self.config["stretch"][key] *= self.resize_factor

    # ----------------------------------------- interactive tuning helpers

    @property
    def temporary_image(self) -> np.ndarray:
        """The tuning image as an integer numpy image: uint8 and uint16 stay,
        floats in [0, 1] become uint8."""
        img = as_numpy(self.current_image)
        if img.dtype in (np.uint8, np.uint16):
            return img
        return (np.clip(np.asarray(img, dtype=float), 0.0, 1.0) * 255.0).astype(np.uint8)

    def show_image(self) -> None:
        """Show the tuning image (floats clipped to [0, 1] before the copy)."""
        plt = optional_module("matplotlib.pyplot", "CurvatureCorrection.show_image")

        img = as_tensor(self.current_image)
        if img.is_floating_point():
            img = img.clamp(0, 1)
        plt.imshow(as_numpy(img))
        plt.show()

    def pre_bulge_correction(self, **kwargs) -> None:
        """Set the "init" bulge step and apply it to the tuning image."""
        self.config["init"] = {
            k: kwargs.get(k, 0)
            for k in (
                "horizontal_bulge",
                "horizontal_center_offset",
                "vertical_bulge",
                "vertical_center_offset",
            )
        }
        self.current_image = self.simple_curvature_correction(
            self.current_image, **self.config["init"]
        )

    def crop(self, corner_points) -> None:
        """Set the crop step from 4 corner voxels (row, col) and apply it to
        the tuning image."""
        self.config["crop"] = {
            "pts_src": make_voxel(np.asarray(corner_points)),
            "width": self.width,
            "height": self.height,
        }
        self.current_image = extract_quadrilateral_ROI(
            self.current_image, indexing="matrix", **self.config["crop"]
        )

    def bulge_correction(self, left=0, right=0, top=0, bottom=0) -> None:
        """Set the bulge step from per-side pixel displacements."""
        hb, hco, vb, vco = self.compute_bulge(left=left, right=right, top=top, bottom=bottom)
        self.config["bulge"] = {
            "horizontal_bulge": hb,
            "horizontal_center_offset": hco,
            "vertical_bulge": vb,
            "vertical_center_offset": vco,
        }
        self.current_image = self.simple_curvature_correction(
            self.current_image, **self.config["bulge"]
        )

    def stretch_correction(self, point_source, point_destination, stretch_center) -> None:
        """Set the stretch step from one displaced point and a fixed center."""
        hs, hco, vs, vco = self.compute_stretch(
            point_source=point_source,
            point_destination=point_destination,
            stretch_center=stretch_center,
        )
        self.config["stretch"] = {
            "horizontal_stretch": hs,
            "horizontal_center_offset": hco,
            "vertical_stretch": vs,
            "vertical_center_offset": vco,
        }
        self.current_image = self.simple_curvature_correction(
            self.current_image, **self.config["stretch"]
        )

    def compute_bulge(self, img=None, **kwargs):
        """Bulge parameters from the largest per-side pixel displacements."""
        left = kwargs.get("left", 0)
        right = kwargs.get("right", 0)
        top = kwargs.get("top", 0)
        bottom = kwargs.get("bottom", 0)
        Ny, Nx = (self.current_image if img is None else img).shape[:2]
        if (left + right == 0) and (top + bottom == 0):
            center = [round(Nx / 2), round(Ny / 2)]
        elif left + right == 0:
            center = [round(Nx / 2), round(Ny * top / (top + bottom))]
        elif top + bottom == 0:
            center = [round(Nx * left / (left + right)), round(Ny / 2)]
        else:
            center = [round(Nx * left / (left + right)), round(Ny * top / (top + bottom))]
        hco = center[0] - round(Nx / 2)
        vco = center[1] - round(Ny / 2)
        hb = left / ((left - center[0]) * center[1] * (Ny - center[1]))
        vb = top / ((top - center[1]) * center[0] * (Nx - center[0]))
        return hb, hco, vb, vco

    def compute_stretch(self, img=None, **kwargs):
        """Stretch parameters from a (source -> destination) point pair."""
        Ny, Nx = (self.current_image if img is None else img).shape[:2]
        pt_src = kwargs.get("point_source", [Ny, Nx])
        pt_dst = kwargs.get("point_destination", [Ny, Nx])
        center = kwargs.get("stretch_center", [round(Ny / 2), round(Nx / 2)])
        hco = center[0] - round(Nx / 2)
        vco = center[1] - round(Ny / 2)

        margin_x, margin_y = round(0.05 * Nx), round(0.05 * Ny)
        if (pt_dst[0] - pt_src[0]) == 0 or not (
            margin_x <= abs(pt_src[0] - center[0])
            and margin_x <= pt_src[0] <= Nx - margin_x
        ):
            hs = 0.0
            if (pt_dst[0] - pt_src[0]) != 0:
                warn("point_source unsuitable for horizontal stretch; set to 0.")
        else:
            hs = -(pt_dst[0] - pt_src[0]) / (
                (pt_src[0] - center[0]) * pt_src[0] * (Nx - pt_src[0])
            )
        if (pt_dst[1] - pt_src[1]) == 0 or not (
            margin_y <= abs(pt_src[1] - center[1])
            and margin_y <= pt_src[1] <= Ny - margin_y
        ):
            vs = 0.0
            if (pt_dst[1] - pt_src[1]) != 0:
                warn("point_source unsuitable for vertical stretch; set to 0.")
        else:
            vs = -(pt_dst[1] - pt_src[1]) / (
                (pt_src[1] - center[1]) * pt_src[1] * (Ny - pt_src[1])
            )
        return hs, hco, vs, vco

    def return_image(self) -> Image:
        """The tuning image as an Image of the configured dimensions."""
        return Image(self.current_image, width=self.width, height=self.height)

    # ------------------------------------------------------ transformation

    @staticmethod
    def _transform_coordinates(X: torch.Tensor, Y: torch.Tensor, **kwargs):
        """Bulge/stretch pull-back map applied to coordinate images."""
        hb = kwargs.get("horizontal_bulge", 0.0)
        hs = kwargs.get("horizontal_stretch", 0.0)
        hco = kwargs.get("horizontal_center_offset", 0)
        vb = kwargs.get("vertical_bulge", 0.0)
        vs = kwargs.get("vertical_stretch", 0.0)
        vco = kwargs.get("vertical_center_offset", 0)

        Ny, Nx = X.shape[:2]
        cx = round(Nx / 2) + hco
        cy = round(Ny / 2) + vco
        Xl = X - cx
        Yl = Y - cy
        ymax, ymin = Yl.max(), Yl.min()
        xmax, xmin = Xl.max(), Xl.min()
        Xmod = Xl + hb * Xl * (ymax - Yl) * (Yl - ymin) + hs * Xl * (xmax - Xl) * (
            Xl - xmin
        )
        Ymod = Yl + vb * Yl * (xmax - Xl) * (Xl - xmin) + vs * Yl * (ymax - Yl) * (
            Yl - ymin
        )
        return Xmod + cx, Ymod + cy

    def simple_curvature_correction(self, img: torch.Tensor, **kwargs) -> torch.Tensor:
        """Apply one bulge/stretch step directly to an image."""
        Ny, Nx = img.shape[:2]
        Y, X = identity_grid((Ny, Nx), img.device)
        Xm, Ym = self._transform_coordinates(X, Y, **kwargs)
        out = warp_backend(
            img.to(torch.float32),
            torch.stack([Ym, Xm], dim=0),
            order=self.interpolation_order,
        )
        if not img.dtype.is_floating_point:
            out = torch.round(out)
        return out.to(img.dtype)

    def _precompute_transformed_coordinates(self, shape: tuple, device) -> None:
        """Push the identity coordinate images through all configured steps."""
        Y, X = identity_grid(tuple(shape), device)
        coords = {"X": X, "Y": Y}
        for key, pixels in coords.items():
            if "init" in self.config:
                pixels = self.simple_curvature_correction(pixels, **self.config["init"])
            if "crop" in self.config:
                pixels = extract_quadrilateral_ROI(
                    pixels, indexing="matrix", **self.config["crop"]
                )
            if "bulge" in self.config:
                pixels = self.simple_curvature_correction(pixels, **self.config["bulge"])
            if "stretch" in self.config:
                pixels = self.simple_curvature_correction(
                    pixels, **self.config["stretch"]
                )
            coords[key] = pixels
        grid = torch.stack([coords["Y"], coords["X"]], dim=0)
        disp = float((grid - identity_grid(tuple(grid.shape[1:]), device)).abs().max())
        self.cache = {
            "grid": grid,
            "key": (tuple(shape), torch.device(device)),
            "max_disp": int(np.ceil(disp)) + 1,
        }
        # Invalidate fused chains built on the previous geometry.
        self._fusion_version += 1

    def _entry(self, shape: tuple, device) -> dict:
        """The cached grid and its bound for ``shape`` on ``device``, built
        once (under ``_GRID_LOCK``) if the cache holds another key."""
        key = (tuple(int(s) for s in shape), torch.device(device))
        entry = self.cache
        if entry.get("key") != key:
            with _GRID_LOCK:
                if self.cache.get("key") != key:
                    self._precompute_transformed_coordinates(key[0], key[1])
                entry = self.cache
        return entry

    def _grid(self, shape: tuple, device) -> torch.Tensor:
        return self._entry(shape, device)["grid"]

    # --------------------------------------------------------------- fusion

    @property
    def fusion_order(self) -> int:
        """Interpolation order for fused chains (fusable only if 1)."""
        return self.interpolation_order

    def pullback_field(self, input_shape: tuple, device):
        """Static pull-back coordinate field on ``device`` (fusion protocol)."""
        return self._grid(input_shape, device), self.correct_metadata()

    # ------------------------------------------------------------ correction

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        entry = self._entry(img.shape[:2], img.device)
        out = warp_backend(
            img.to(torch.float32),
            entry["grid"],
            order=self.interpolation_order,
            max_disp=entry["max_disp"],
        )
        if not img.dtype.is_floating_point:
            out = torch.round(out)
        return out.to(img.dtype)

    def correct_metadata(self, metadata: Optional[dict] = None) -> dict:
        meta: dict = {}
        crop = self.config.get("crop")
        if crop is not None:
            meta["dimensions"] = [crop["height"], crop["width"]]
            meta["origin"] = np.array([0.0, crop["height"]])
        return meta

    # ------------------------------------------------------------------- I/O

    def save(self, path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        cfg = {
            k: (
                {kk: np.asarray(vv) if isinstance(vv, np.ndarray) else vv for kk, vv in v.items()}
                if isinstance(v, dict)
                else v
            )
            for k, v in self.config.items()
        }
        np.savez(path, class_name=type(self).__name__, config=np.array([cfg], dtype=object))

    def load(self, path) -> None:
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"File {path} not found.")
        data = load_npz(path)
        self.config = load_curvature_correction_config_from_dict(data["config"][0])
        self.cache = {}
