"""Piecewise-linear colour paths in RGB space.

Counterpart of :mod:`darsia_tpu.signals.color.color_path`.  ``fit`` (each
colour's closest point on the path) is one tensor function over the stacked
segments on the colours' device; its temporaries are (..., S, 3).  The
path's supports are uploaded once per device and kept there, so a call
copies nothing from the host.  The path itself, ``refine`` and ``interpret``
of host parameters stay float64 numpy, as in the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from ...image.image import as_numpy, as_tensor
from ...utils.optional import optional_module
from .color_mode import ColorMode

__all__ = ["ColorPath", "define_color_path"]


class ColorPath:
    """Piecewise linear colour path with pixel parametrization."""

    def __init__(
        self,
        colors: Optional[list] = None,
        base_color: Optional[np.ndarray] = None,
        relative_colors: Optional[list] = None,
        mode: Literal["rgb", "lab", "hcl"] = "rgb",
        name: str = "ColorPath",
    ) -> None:
        assert colors is not None or relative_colors is not None
        assert not (colors is not None and relative_colors is not None)
        assert not (relative_colors is not None and base_color is None)

        if colors is not None:
            self.colors = [np.asarray(c, dtype=float) for c in colors]
            self.base_color = (
                np.asarray(base_color, dtype=float) if base_color is not None else self.colors[0]
            )
            self.relative_colors = [c - self.base_color for c in self.colors]
        else:
            self.relative_colors = [np.asarray(c, dtype=float) for c in relative_colors]
            self.base_color = np.asarray(base_color, dtype=float)
            self.colors = [self.base_color + c for c in self.relative_colors]

        self.relative_distances = self._compute_relative_distances()
        self.equidistant_distances = np.linspace(0.0, 1.0, len(self.colors)).tolist()
        self.num_segments = len(self.colors) - 1
        self.mode = mode
        self.name = name
        self._on_device: dict = {}

    def _compute_relative_distances(self) -> list[float]:
        distances = [
            float(np.linalg.norm(self.relative_colors[i] - self.relative_colors[i - 1]))
            for i in range(1, len(self.relative_colors))
        ]
        total = sum(distances) if sum(distances) > 0 else 1.0
        return (np.cumsum([0.0] + distances) / total).tolist()

    # ------------------------------------------------------------- sampling

    def sample_absolute_color_path(self, n_colors: int = 256) -> list[np.ndarray]:
        """Sample ``n_colors`` along the path."""
        sampled = self.interpret(np.linspace(0.0, 1.0, n_colors), ColorMode.ABSOLUTE)
        return [sampled[i] for i in range(n_colors)]

    def get_color_map(self, n_colors: int = 256, name: Optional[str] = None):
        """Matplotlib colormap along the path."""
        colors = optional_module("matplotlib.colors", "ColorPath.get_color_map")

        sampled = np.clip(np.array(self.sample_absolute_color_path(n_colors)), 0, 1)
        return colors.ListedColormap(sampled, name=name or self.name)

    def show_cmap(self) -> None:
        plt = optional_module("matplotlib.pyplot", "ColorPath.show_cmap")

        gradient = np.linspace(0, 1, 256)[None].repeat(16, axis=0)
        plt.imshow(gradient, cmap=self.get_color_map(), aspect="auto")
        plt.show()

    def show_path(self, **kwargs) -> None:
        plt = optional_module("matplotlib.pyplot", "ColorPath.show_path")

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        pts = np.array(self.colors)
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "o-")
        ax.set_xlabel("R")
        ax.set_ylabel("G")
        ax.set_zlabel("B")
        plt.show()

    # ------------------------------------------------------------------- io

    def to_dict(self) -> dict:
        return {
            "colors": [c.tolist() for c in self.colors],
            "base_color": self.base_color.tolist(),
            "mode": self.mode,
            "name": self.name,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ColorPath":
        return cls(
            colors=[np.asarray(c) for c in data["colors"]],
            base_color=np.asarray(data["base_color"]),
            mode=data.get("mode", "rgb"),
            name=data.get("name", "ColorPath"),
        )

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: Path) -> "ColorPath":
        return cls.from_dict(json.loads(Path(path).read_text()))

    # ------------------------------------------------------------- numerics

    def refine(
        self,
        num_segments: int,
        distance_to_left: Optional[float] = None,
        distance_to_right: Optional[float] = None,
        mode: Literal["relative", "equidistant"] = "relative",
    ) -> "ColorPath":
        """Resample the path into ``num_segments`` segments, optionally
        extended beyond its ends (``distance_to_left`` e.g. -0.1,
        ``distance_to_right`` e.g. 1.1)."""
        distances = np.linspace(0.0, 1.0, num_segments + 1)
        if distance_to_left is not None:
            distances = np.hstack((distance_to_left, distances))
        if distance_to_right is not None:
            distances = np.hstack((distances, distance_to_right))
        relative_colors = self.interpret(distances, color_mode=ColorMode.RELATIVE, mode=mode)
        return ColorPath(
            base_color=self.base_color,
            relative_colors=[c for c in relative_colors],
            mode=self.mode,
            name=self.name,
        )

    def _supports_distances(self, color_mode, mode):
        supports = self.colors if color_mode == ColorMode.ABSOLUTE else self.relative_colors
        distances = self.equidistant_distances if mode == "equidistant" else self.relative_distances
        return np.asarray(supports), np.asarray(distances)

    def _segments(self, color_mode, mode, device) -> dict:
        """The float32 segment constants of ``fit`` on ``device``, made once
        per device (and again if the path's colours change)."""
        supports, distances = self._supports_distances(color_mode, mode)
        key = (str(color_mode), mode, str(device))
        fingerprint = supports.tobytes() + distances.tobytes()
        held = self._on_device.get(key)
        if held is not None and held[0] == fingerprint:
            return held[1]
        sup = torch.from_numpy(supports.astype(np.float32)).to(device)
        dist = torch.from_numpy(distances.astype(np.float32)).to(device)
        n_seg = self.num_segments
        seg_vec = sup[1:] - sup[:-1]
        d0, d1 = dist[:-1], dist[1:]
        first = torch.arange(n_seg, device=device) == 0
        last = torch.arange(n_seg, device=device) == n_seg - 1
        segments = {
            "start": sup[:-1],
            "vec": seg_vec,
            "len_sq": torch.clamp((seg_vec**2).sum(-1), min=1e-30),
            "d0": d0,
            "dd": d1 - d0,
            "dd_safe": torch.clamp(d1 - d0, min=1e-30),
            # Segment-wise clipping; the first and last segments are open.
            "lo": torch.where(first, -torch.inf, d0),
            "hi": torch.where(last, torch.inf, d1),
        }
        self._on_device[key] = (fingerprint, segments)
        return segments

    def fit_terms(self, colors, color_mode: ColorMode, mode="relative"):
        """(parameter, l1 distance) of each colour's closest point on every
        segment, each (..., S), on the colours' device (a numpy array goes to
        the card)."""
        c = as_tensor(colors).to(torch.float32)
        seg = self._segments(color_mode, mode, c.device)
        diff = c[..., None, :] - seg["start"]
        t = (diff * seg["vec"]).sum(-1) / seg["len_sq"]
        interp = seg["d0"] + t * seg["dd"]
        interp = torch.minimum(torch.maximum(interp, seg["lo"]), seg["hi"])
        ratio = (interp - seg["d0"]) / seg["dd_safe"]
        proj = seg["start"] + ratio[..., None] * seg["vec"]
        l1 = (c[..., None, :] - proj).abs().sum(-1)
        return interp, l1

    def fit(
        self,
        colors,
        color_mode: ColorMode,
        mode: Literal["equidistant", "relative"] = "relative",
    ) -> torch.Tensor:
        """Closest-point parametrization of colours (..., 3) along the path:
        a float32 tensor (...) on the colours' device (the first of equally
        close segments wins, as ``argmin`` picks it in both libraries)."""
        interp, l1 = self.fit_terms(colors, color_mode, mode)
        best = l1.argmin(dim=-1, keepdim=True)
        return torch.nan_to_num(interp.gather(-1, best)[..., 0], nan=0.0)

    def interpret(
        self,
        parameters,
        color_mode: ColorMode,
        mode: Literal["equidistant", "relative"] = "relative",
    ):
        """Colours along the path at given parameters (inverse of ``fit``):
        float64 numpy for host parameters, a tensor on the parameters' device
        (in their dtype) for a tensor.  The first and last segments are open
        (extrapolation)."""
        supports, distances = self._supports_distances(color_mode, mode)
        if isinstance(parameters, torch.Tensor):
            params = parameters
            sup = torch.from_numpy(supports).to(params.device, params.dtype)
            out = torch.zeros(params.shape + (3,), dtype=params.dtype, device=params.device)
        else:
            params = np.asarray(parameters, dtype=float)
            sup = supports
            out = np.zeros(params.shape + (3,))
        for segment in range(self.num_segments):
            d0, d1 = float(distances[segment]), float(distances[segment + 1])
            lo_ok = params >= d0 if segment > 0 else None
            hi_ok = params <= d1 if segment < self.num_segments - 1 else None
            ratio = (params - d0) / max(d1 - d0, 1e-30)
            value = sup[segment] + ratio[..., None] * (sup[segment + 1] - sup[segment])
            if lo_ok is None and hi_ok is None:
                out = value
                continue
            mask = lo_ok if hi_ok is None else hi_ok if lo_ok is None else lo_ok & hi_ok
            if isinstance(out, torch.Tensor):
                out = torch.where(mask[..., None], value, out)
            else:
                out = np.where(mask[..., None], value, out)
        return out


def define_color_path(image, mask, num_colors: int = 5, name: str = "ColorPath") -> ColorPath:
    """A colour path from masked image pixels (non-interactive): k-means of
    the masked colours on the host, the centres ordered along their first
    principal direction."""
    from ...utils.kmeans import kmeans

    data = as_numpy(image.img if hasattr(image, "img") else image)
    mask_arr = as_numpy(mask.img if hasattr(mask, "img") else mask).astype(bool)
    pixels = data[mask_arr].reshape(-1, data.shape[-1])
    if pixels.shape[0] < num_colors:
        raise ValueError("Not enough masked pixels to define a color path.")
    _, centers = kmeans(pixels, num_colors)
    centered = centers - centers.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    order = np.argsort(centered @ vt[0])
    return ColorPath(colors=[centers[i] for i in order], name=name)
