"""[restoration] section (parity: reference
``presets/workflows/config/restoration.py:11-120``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from .toml_utils import get_section

__all__ = ["VolumeAveragingConfig", "TVDConfig", "RestorationConfig"]


@dataclass
class VolumeAveragingConfig:
    rev_size: int = 3

    def load(self, sec: dict) -> "VolumeAveragingConfig":
        self.rev_size = int(sec.get("rev_size", self.rev_size))
        return self


@dataclass
class TVDConfig:
    method: str = "chambolle"
    weight: Union[float, str] = 0.1
    max_num_iter: int = 200
    eps: float = 2e-4
    omega: float = 1.0
    regularization: float = 1.0
    kwargs: dict = field(default_factory=dict)

    def load(self, sec: dict) -> "TVDConfig":
        self.method = str(sec.get("method", self.method)).lower()
        raw_weight = sec.get("weight", self.weight)
        self.weight = (
            raw_weight
            if isinstance(raw_weight, str)
            else float(raw_weight)
        )
        self.max_num_iter = int(sec.get("max_num_iter", self.max_num_iter))
        self.eps = float(sec.get("eps", self.eps))
        self.omega = float(sec.get("omega", self.omega))
        self.regularization = float(
            sec.get("regularization", self.regularization)
        )
        self.kwargs = dict(sec.get("kwargs", {}))
        return self


@dataclass
class RestorationConfig:
    method: Optional[str] = "volume_average"
    options: Optional[Union[VolumeAveragingConfig, TVDConfig]] = None
    ignore: list = field(default_factory=list)

    def load(self, path) -> "RestorationConfig":
        sec = get_section(path, "restoration")
        self.method = str(sec.get("method", self.method)).lower()
        if self.method in ("volume_average", "volume_averaging"):
            self.options = VolumeAveragingConfig().load(sec)
        elif self.method == "tvd":
            self.options = TVDConfig().load(sec)
        elif self.method in ("none", ""):
            self.method, self.options = None, None
        else:
            raise ValueError(f"Unknown restoration method {self.method!r}.")
        self.ignore = list(sec.get("ignore", []))
        return self

    def make(self, img=None, weight_override=None):
        """Instantiate the configured restoration operator.

        ``img`` (a template image) is required for volume averaging, whose
        REV size is expressed in physical units; the averaging runs on its
        device.
        """
        from .... import restoration as da

        if self.method is None:
            return None
        if isinstance(self.options, VolumeAveragingConfig):
            if img is None:
                raise ValueError(
                    "Volume averaging needs a template image to size its REV."
                )
            import numpy as np

            rev = da.REV(float(self.options.rev_size), img)
            shape = tuple(img.img.shape[: img.coordinatesystem.dim])
            return da.VolumeAveraging(rev, mask=np.ones(shape, dtype=bool), device=img.img.device)
        assert isinstance(self.options, TVDConfig)
        weight = (
            weight_override
            if weight_override is not None
            else self.options.weight
        )
        return da.TVD(
            weight=weight,
            method=self.options.method,
            max_num_iter=self.options.max_num_iter,
            eps=self.options.eps,
            omega=self.options.omega,
            regularization=self.options.regularization,
            **self.options.kwargs,
        )
