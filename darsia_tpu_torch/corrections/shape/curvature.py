"""Curvature correction: crop + bulge + stretch polynomial warps.

Counterpart of :mod:`darsia_tpu.corrections.shape.curvature` (the correction
itself; the interactive tuning helpers are not ported).  The correction is a
coordinate-field generator: the pull-back grid is computed once per input
shape and device by pushing the identity coordinate images through the
configured steps (init -> crop -> bulge -> stretch), so the whole correction
costs one resampling pass per image.

Config (dict, ``.json`` file, or the ``[curvature]`` section of a ``.toml``):

* ``init`` / ``bulge``: horizontal/vertical_bulge, *_center_offset
* ``crop``: pts_src (4 corner voxels, (row, col), TL-BL-BR-TR), width, height
* ``stretch``: horizontal/vertical_stretch, *_center_offset
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ...ops.warp import identity_grid, warp_backend
from ..base import BaseCorrection
from .quad import extract_quadrilateral_ROI

__all__ = ["CurvatureCorrection", "load_curvature_correction_config_from_dict"]

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


def load_curvature_correction_config_from_dict(sec: dict) -> dict:
    """Normalize a curvature config dict (see the module docstring)."""
    config: dict = {}
    for key, defaults in (("init", _BULGE_KEYS), ("bulge", _BULGE_KEYS)):
        if sec.get(key) is not None:
            config[key] = {k: sec[key].get(k, d) for k, d in defaults.items()}
    if sec.get("crop") is not None:
        config["crop"] = {
            # Corner voxels in (row, col) order, as the JAX package's
            # VoxelArray holds them.
            "pts_src": np.asarray(sec["crop"].get("pts_src", []), dtype=float),
            "width": sec["crop"].get("width", 1.0),
            "height": sec["crop"].get("height", 1.0),
        }
    if sec.get("stretch") is not None:
        config["stretch"] = {
            k: sec["stretch"].get(k, d) for k, d in _STRETCH_KEYS.items()
        }
    return config


def _read_config_file(path: Path) -> dict:
    if path.suffix == ".json":
        return load_curvature_correction_config_from_dict(json.loads(path.read_text()))
    if path.suffix == ".toml":
        import tomllib

        data = tomllib.loads(path.read_text())
        return load_curvature_correction_config_from_dict(data.get("curvature", {}))
    raise ValueError(f"Unsupported config file {path}.")


class CurvatureCorrection(BaseCorrection):
    """Polynomial curvature correction (crop/bulge/stretch)."""

    def __init__(
        self, config: Union[dict, str, Path, list, None] = None, **kwargs
    ) -> None:
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
        if not math.isclose(kwargs.get("resize_factor", 1.0), 1.0):
            raise NotImplementedError("resize_factor is not ported yet")
        self.interpolation_order: int = kwargs.get("interpolation_order", 1)
        self.cache: dict = {}
        self._fusion_version = 0

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

    def _grid(self, shape: tuple, device) -> torch.Tensor:
        key = (tuple(int(s) for s in shape), torch.device(device))
        if self.cache.get("key") != key:
            self._precompute_transformed_coordinates(key[0], key[1])
        return self.cache["grid"]

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
        grid = self._grid(img.shape[:2], img.device)
        out = warp_backend(
            img.to(torch.float32),
            grid,
            order=self.interpolation_order,
            max_disp=self.cache["max_disp"],
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
