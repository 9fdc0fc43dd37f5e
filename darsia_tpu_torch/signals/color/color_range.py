"""Colour ranges and spectra: membership of colours in calibrated sets.

Counterpart of :mod:`darsia_tpu.signals.color.color_range`.  The fits, the
histograms and the saved files are host numpy in float64, as in the JAX
package.  The tests evaluated per pixel of a photograph (``contains``,
``in_spectrum``, ``weight``, ``distance``) take a tensor too and then stay on
its device: the quantisation runs in float64 there (``torch.round`` rounds
half to even, as ``np.round`` does), and the occupied bins are a boolean
lookup table kept once per device.  A numpy array gives a numpy answer,
computed as the JAX package computes it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = [
    "ColorRange",
    "DiscreteColorRange",
    "ColorSpectrum",
    "color_to_index",
    "index_to_color",
    "flatten_index",
    "unflatten_index",
]


def _box(min_color, max_color) -> tuple[np.ndarray, np.ndarray]:
    lo = np.zeros(3) if min_color is None else np.asarray(min_color, float)
    hi = np.ones(3) if max_color is None else np.asarray(max_color, float)
    return lo, hi


def color_to_index(colors, resolution: int, min_color=None, max_color=None):
    """Quantize colours to integer grid indices within a box.

    Default box is [0, 1]^3; pass min/max for e.g. relative colours in
    [-1, 1]^3.  The arithmetic is float64 and rounds half to even, for a
    numpy array (int64 numpy out) and for a tensor (int64 on its device).
    """
    lo, hi = _box(min_color, max_color)
    span = np.maximum(hi - lo, 1e-12)
    if isinstance(colors, torch.Tensor):
        colors = colors.to(torch.float64)
        lo_t = torch.as_tensor(lo, device=colors.device)
        span_t = torch.as_tensor(span, device=colors.device)
        scaled = torch.clamp((colors - lo_t) / span_t, 0.0, 1.0) * (resolution - 1)
        return torch.round(scaled).to(torch.int64)
    colors = np.asarray(colors, dtype=float)
    scaled = np.clip((colors - lo) / span, 0.0, 1.0) * (resolution - 1)
    return np.round(scaled).astype(np.int64)


def index_to_color(index, resolution: int, min_color=None, max_color=None) -> np.ndarray:
    """Bin-centre colours for integer grid indices (inverse of
    :func:`color_to_index`)."""
    lo, hi = _box(min_color, max_color)
    return lo + np.asarray(index, dtype=float) / (resolution - 1) * (hi - lo)


def unflatten_index(ids, resolution: int) -> np.ndarray:
    """Linear ids -> 3d quantization indices (inverse of flatten_index)."""
    ids = np.asarray(ids, dtype=np.int64)
    return np.stack(
        [ids // (resolution * resolution), (ids // resolution) % resolution, ids % resolution],
        axis=-1,
    )


def flatten_index(index, resolution: int):
    """Flatten 3d quantization indices to linear ids (numpy or tensor)."""
    if not isinstance(index, torch.Tensor):
        index = np.asarray(index)
    return index[..., 0] * resolution * resolution + index[..., 1] * resolution + index[..., 2]


def _in_bounds(colors, lower: np.ndarray, upper: np.ndarray):
    """Whether each colour lies in [lower, upper] in every channel."""
    if isinstance(colors, torch.Tensor):
        colors = colors.to(torch.float64)
        lo = torch.as_tensor(lower, dtype=torch.float64, device=colors.device)
        hi = torch.as_tensor(upper, dtype=torch.float64, device=colors.device)
        return torch.all((colors >= lo) & (colors <= hi), dim=-1)
    colors = np.asarray(colors, dtype=float)
    return np.all((colors >= lower) & (colors <= upper), axis=-1)


class ColorRange:
    """Axis-aligned box in colour space with membership tests."""

    def __init__(
        self,
        min_color: Optional[np.ndarray] = None,
        max_color: Optional[np.ndarray] = None,
        color_mode=None,
    ) -> None:
        self.min_color = np.zeros(3) if min_color is None else np.asarray(min_color, float).ravel()
        self.max_color = np.ones(3) if max_color is None else np.asarray(max_color, float).ravel()
        if color_mode is None:
            from .color_mode import ColorMode

            color_mode = ColorMode.ABSOLUTE
        self.color_mode = color_mode

    @staticmethod
    def _samples(images, baseline=None, mask=None):
        """Each image's colours (baseline-relative, masked) as (N, 3) float
        arrays on the host."""
        from ...image.image import as_numpy

        base = None if baseline is None else as_numpy(baseline.img)
        for image in images:
            array = as_numpy(image.img if hasattr(image, "img") else image)
            if base is not None:
                array = array - base
            if mask is not None:
                array = array[as_numpy(mask.img if hasattr(mask, "img") else mask).astype(bool)]
            yield array.reshape(-1, 3)

    @classmethod
    def from_images(cls, images, baseline=None, mask=None, **kwargs):
        """Bounding colour box over a set of (optionally baseline-relative,
        masked) images."""
        from .color_mode import ColorMode

        min_color = np.full(3, np.inf)
        max_color = np.full(3, -np.inf)
        color_mode = ColorMode.ABSOLUTE
        for flat in cls._samples(images, baseline, mask):
            min_color = np.minimum(min_color, flat.min(axis=0))
            max_color = np.maximum(max_color, flat.max(axis=0))
            if baseline is not None:
                color_mode = ColorMode.RELATIVE
        return cls(min_color, max_color, color_mode=color_mode)

    def to_dict(self) -> dict:
        return {
            "min_color": self.min_color.tolist(),
            "max_color": self.max_color.tolist(),
            "color_mode": getattr(self.color_mode, "name", str(self.color_mode)),
        }

    @classmethod
    def load_from_dict(cls, data: dict) -> "ColorRange":
        from .color_mode import ColorMode

        return cls(
            np.asarray(data["min_color"]),
            np.asarray(data["max_color"]),
            color_mode=ColorMode[data["color_mode"]] if "color_mode" in data else None,
        )

    def fit(self, colors: np.ndarray, expand: float = 0.0) -> "ColorRange":
        """Fit the bounding box of a colour sample (optionally expanded)."""
        colors = np.asarray(colors, dtype=float).reshape(-1, 3)
        span = colors.max(axis=0) - colors.min(axis=0)
        self.min_color = colors.min(axis=0) - expand * span
        self.max_color = colors.max(axis=0) + expand * span
        return self

    def contains(self, colors):
        """Membership of colours (..., 3): numpy in, numpy out; a tensor
        stays on its device."""
        return _in_bounds(colors, self.min_color, self.max_color)

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps({"min_color": self.min_color.tolist(), "max_color": self.max_color.tolist()})
        )

    @classmethod
    def load(cls, path: Path) -> "ColorRange":
        data = json.loads(Path(path).with_suffix(".json").read_text())
        return cls(np.asarray(data["min_color"]), np.asarray(data["max_color"]))


class DiscreteColorRange(ColorRange):
    """Quantized occupancy grid over colour space (discrete membership)."""

    def __init__(self, resolution: int = 51) -> None:
        super().__init__()
        self.resolution = resolution
        self.occupancy: set[int] = set()
        self._lookups: dict = {}

    @property
    def shape(self) -> tuple:
        """Shape of the discrete colour raster."""
        return (self.resolution, self.resolution, self.resolution)

    def colors(self, flat: bool = False) -> np.ndarray:
        """All raster node colours: the regular grid spanning [min_color,
        max_color], shape (R, R, R, 3) or flat (R^3, 3)."""
        linspaces = [
            np.linspace(self.min_color[i], self.max_color[i], self.resolution) for i in range(3)
        ]
        colors = np.stack(np.meshgrid(*linspaces, indexing="ij"), axis=-1)
        return colors.reshape((-1, 3)) if flat else colors

    def _ids(self, colors):
        return flatten_index(
            color_to_index(colors, self.resolution, self.min_color, self.max_color),
            self.resolution,
        )

    def fit(self, colors: np.ndarray, expand: float = 0.0) -> "DiscreteColorRange":
        super().fit(colors, expand)
        self.occupancy = set(np.unique(self._ids(np.asarray(colors).reshape(-1, 3))).tolist())
        return self

    def _slack(self) -> np.ndarray:
        # Half-bin slack: box-edge colours still quantize to edge bins.
        return 0.5 * (self.max_color - self.min_color) / (self.resolution - 1)

    def _in_box(self, colors):
        slack = self._slack()
        return _in_bounds(colors, self.min_color - slack, self.max_color + slack)

    def _lookup_table(self) -> np.ndarray:
        lookup = np.zeros(self.resolution**3, dtype=bool)
        if self.occupancy:
            lookup[np.fromiter(self.occupancy, dtype=np.int64)] = True
        return lookup

    def _lookup_on(self, device) -> torch.Tensor:
        """The occupied bins as a boolean table on ``device``, rebuilt when
        the occupancy or the resolution changed."""
        key = (self.resolution, frozenset(self.occupancy))
        held = self._lookups.get(device)
        if held is None or held[0] != key:
            table = torch.from_numpy(self._lookup_table()).to(device)
            held = self._lookups[device] = (key, table)
        return held[1]

    def contains(self, colors):
        """Membership of colours (..., 3) in the occupied bins: numpy in,
        numpy out; a tensor stays on its device."""
        if isinstance(colors, torch.Tensor):
            return self._lookup_on(colors.device)[self._ids(colors)] & self._in_box(colors)
        colors = np.asarray(colors, dtype=float)
        return self._lookup_table()[self._ids(colors)] & self._in_box(colors)

    # -- quantization helpers --

    def color_to_index(self, color: np.ndarray) -> np.ndarray:
        """Colour array (N, 3) -> per-channel raster indices (N, 3)."""
        color = np.asarray(color, dtype=float)
        indices = color_to_index(
            color.reshape(-1, 3), self.resolution, self.min_color, self.max_color
        )
        return indices[0] if color.ndim == 1 else indices

    def flatten_index(self, index: np.ndarray) -> np.ndarray:
        """Per-channel indices -> flat raster index."""
        index = np.asarray(index)
        flat = flatten_index(index.reshape(-1, 3), self.resolution)
        return flat[0] if index.ndim == 1 else flat

    def flat_color_index(self, color: np.ndarray) -> np.ndarray:
        """Colour array -> flat raster indices (compose the two above)."""
        return self.flatten_index(self.color_to_index(color))

    @classmethod
    def from_images(
        cls, images, baseline=None, mask=None, resolution: int = 51, **kwargs
    ) -> "DiscreteColorRange":
        """Occupancy grid over the colours observed in images."""
        box = ColorRange.from_images(images, baseline=baseline, mask=mask)
        out = cls(resolution)
        out.color_mode = box.color_mode
        out.fit(np.concatenate(list(cls._samples(images, baseline, mask)), axis=0))
        return out

    def to_dict(self) -> dict:
        return {
            **super().to_dict(),
            "resolution": self.resolution,
            "occupancy": sorted(self.occupancy),
        }

    @classmethod
    def load_from_dict(cls, data: dict) -> "DiscreteColorRange":
        out = cls(int(data["resolution"]))
        out.min_color = np.asarray(data["min_color"], float)
        out.max_color = np.asarray(data["max_color"], float)
        out.occupancy = set(int(i) for i in data.get("occupancy", []))
        if "color_mode" in data:
            from .color_mode import ColorMode

            out.color_mode = ColorMode[data["color_mode"]]
        return out

    def expand(self, iterations: int = 1) -> "DiscreteColorRange":
        """Morphologically dilate the occupancy in quantized colour space."""
        if not self.occupancy:
            return self
        from scipy import ndimage

        grid = np.zeros((self.resolution,) * 3, dtype=bool)
        grid.reshape(-1)[np.fromiter(self.occupancy, dtype=np.int64)] = True
        grid = ndimage.binary_dilation(grid, iterations=iterations)
        self.occupancy = set(np.nonzero(grid.reshape(-1))[0].tolist())
        return self

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            resolution=self.resolution,
            occupancy=np.fromiter(self.occupancy, dtype=np.int64)
            if self.occupancy
            else np.zeros(0, dtype=np.int64),
            min_color=self.min_color,
            max_color=self.max_color,
        )

    @classmethod
    def load(cls, path: Path) -> "DiscreteColorRange":
        data = np.load(Path(path).with_suffix(".npz"))
        out = cls(int(data["resolution"]))
        out.occupancy = set(data["occupancy"].tolist())
        out.min_color = data["min_color"]
        out.max_color = data["max_color"]
        return out


class ColorSpectrum(DiscreteColorRange):
    """Observed colour spectrum of a region: the discrete range with
    histogram weights."""

    def __init__(self, resolution: int = 51, base_color=None) -> None:
        super().__init__(resolution)
        self.counts: dict[int, int] = {}
        self.base_color = np.zeros(3) if base_color is None else np.asarray(base_color, float)

    def _set_counts(self, counts: dict) -> "ColorSpectrum":
        self.counts = counts
        self.occupancy = set(counts.keys())
        return self

    def fit(self, colors: np.ndarray, expand: float = 0.0) -> "ColorSpectrum":
        super().fit(colors, expand)
        unique, counts = np.unique(self._ids(np.asarray(colors).reshape(-1, 3)), return_counts=True)
        self.counts = dict(zip(unique.tolist(), counts.tolist()))
        return self

    def accumulate(self, colors: np.ndarray) -> "ColorSpectrum":
        """Add colours to the histogram without re-fitting the box."""
        unique, counts = np.unique(self._ids(np.asarray(colors).reshape(-1, 3)), return_counts=True)
        merged = dict(self.counts)
        for key, value in zip(unique.tolist(), counts.tolist()):
            merged[key] = merged.get(key, 0) + value
        return self._set_counts(merged)

    def threshold(self, threshold_significant: float = 0.0) -> "ColorSpectrum":
        """Keep only bins whose probability exceeds the threshold."""
        total = max(sum(self.counts.values()), 1)
        return self._set_counts(
            {k: v for k, v in self.counts.items() if v / total > threshold_significant}
        )

    def remove(self, other: "DiscreteColorRange") -> "ColorSpectrum":
        """Remove another spectrum's occupied bins."""
        return self._set_counts({k: v for k, v in self.counts.items() if k not in other.occupancy})

    @property
    def relative_colors(self) -> np.ndarray:
        """Occupied bin-centre colours (relative to base_color if the box is
        a relative-colour box)."""
        if not self.counts:
            return np.zeros((0, 3))
        ids = np.fromiter(self.counts.keys(), dtype=np.int64, count=len(self.counts))
        return index_to_color(
            unflatten_index(ids, self.resolution), self.resolution, self.min_color, self.max_color
        )

    @property
    def colors(self) -> np.ndarray:
        return self.base_color + self.relative_colors

    @property
    def probabilities(self) -> np.ndarray:
        if not self.counts:
            return np.zeros(0)
        vals = np.fromiter(self.counts.values(), dtype=float, count=len(self.counts))
        return vals / max(vals.sum(), 1.0)

    def distance(self, color):
        """Minimum Euclidean distance of (relative) colours to the occupied
        spectrum; 0.0 when empty.  A tensor (..., 3) gives a float64 tensor
        on its device."""
        spectrum = self.relative_colors
        if len(spectrum) == 0:
            return 0.0
        if isinstance(color, torch.Tensor):
            if color.dim() == 1:
                return self.distance(color.cpu().numpy())
            flat = color.reshape(-1, 3).to(torch.float64)
            support = torch.from_numpy(spectrum).to(color.device)
            dists = torch.linalg.vector_norm(flat[:, None, :] - support[None, :, :], dim=-1)
            return dists.min(dim=1).values.reshape(color.shape[:-1])
        color = np.asarray(color, dtype=float)
        if color.ndim == 1:
            return float(np.min(np.linalg.norm(spectrum - color, axis=1)))
        flat = color.reshape(-1, 3)
        dists = np.min(np.linalg.norm(flat[:, None, :] - spectrum[None, :, :], axis=-1), axis=1)
        return dists.reshape(color.shape[:-1])

    def in_spectrum(self, colors, color_mode):
        """Membership of colours in the occupied bins (quantized comparison
        at bin resolution); a tensor stays on its device."""
        from .color_mode import ColorMode

        if color_mode == ColorMode.RELATIVE:
            check = colors
        elif color_mode == ColorMode.ABSOLUTE:
            if isinstance(colors, torch.Tensor):
                check = colors.to(torch.float64) - torch.as_tensor(
                    self.base_color, dtype=torch.float64, device=colors.device
                )
            else:
                check = np.asarray(colors, dtype=float) - self.base_color
        else:
            raise ValueError(f"Unsupported color mode: {color_mode}")
        return self.contains(check)

    def to_dict(self) -> dict:
        return {
            "resolution": self.resolution,
            "counts": {str(k): v for k, v in self.counts.items()},
            "min_color": self.min_color.tolist(),
            "max_color": self.max_color.tolist(),
            "base_color": self.base_color.tolist(),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ColorSpectrum":
        out = cls(int(data["resolution"]))
        out._set_counts({int(k): int(v) for k, v in data["counts"].items()})
        out.min_color = np.asarray(data["min_color"])
        out.max_color = np.asarray(data["max_color"])
        out.base_color = np.asarray(data.get("base_color", np.zeros(3)))
        return out

    def save(self, path: Path) -> None:
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        count = len(self.counts)
        np.savez(
            path,
            resolution=self.resolution,
            keys=np.fromiter(self.counts.keys(), dtype=np.int64, count=count),
            values=np.fromiter(self.counts.values(), dtype=np.int64, count=count),
            min_color=self.min_color,
            max_color=self.max_color,
            base_color=self.base_color,
        )

    @classmethod
    def load(cls, path: Path) -> "ColorSpectrum":
        data = np.load(Path(path).with_suffix(".npz"))
        out = cls(int(data["resolution"]))
        out._set_counts(dict(zip(data["keys"].tolist(), data["values"].tolist())))
        out.min_color = data["min_color"]
        out.max_color = data["max_color"]
        out.base_color = data["base_color"] if "base_color" in data else np.zeros(3)
        return out

    def weight(self, colors):
        """Relative histogram weight of each colour (0 if unseen); a tensor
        gives float64 on its device."""
        total = max(sum(self.counts.values()), 1)
        lookup = np.zeros(self.resolution**3, dtype=float)
        for key, value in self.counts.items():
            lookup[key] = value / total
        if isinstance(colors, torch.Tensor):
            table = torch.from_numpy(lookup).to(colors.device)
            return table[self._ids(colors)] * self._in_box(colors)
        colors = np.asarray(colors, dtype=float)
        return lookup[self._ids(colors)] * self._in_box(colors)
