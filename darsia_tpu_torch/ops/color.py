"""Colour-space conversions as elementwise tensor ops.

Counterpart of :mod:`darsia_tpu.ops.color`.  Float conventions: RGB in
[0, 1], HSV hue in degrees [0, 360), LAB with L in [0, 100]; integer images
are mapped to [0, 1] first.  All functions take a trailing channel axis.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "convert_trichromatic",
    "hsv_to_rgb",
    "lab_to_rgb",
    "rgb_to_gray",
    "rgb_to_hls",
    "rgb_to_hsv",
    "rgb_to_lab",
    "to_monochromatic",
]

# ITU-R BT.601 luma weights.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)
# sRGB <-> CIE XYZ (D65).
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.53715, -0.498535),
    (-0.969256, 1.875991, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return _device_const(values, like.device)


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant table on ``device``, copied there once (a host copy per
    call would synchronise the stream)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """Integer images to [0, 1] float32 (uint8 by 255, others by 65535)."""
    if x.dtype.is_floating_point:
        return x.to(torch.float32)
    scale = 255.0 if x.dtype == torch.uint8 else 65535.0
    return x.to(torch.float32) / scale


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Luma grayscale of an (..., 3) image, preserving the input scale."""
    x = rgb.to(torch.float32)
    gray = torch.tensordot(x, _const(_GRAY_WEIGHTS, x), dims=([-1], [0]))
    if not rgb.dtype.is_floating_point:
        return torch.round(gray).to(rgb.dtype)
    return gray.to(rgb.dtype)


def _hue(r, g, b, maxc, delta):
    """Hue in degrees of the max/delta decomposition shared by HSV and HLS."""
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.remainder(h * 60.0, 360.0)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV: H in [0, 360), S, V in [0, 1]."""
    x = _as_float(rgb)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(maxc == 0, torch.ones_like(maxc), maxc)
    s = torch.where(maxc == 0, torch.zeros_like(maxc), delta / safe)
    return torch.stack([_hue(r, g, b, maxc, delta), s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV (H in degrees) -> RGB in [0, 1]."""
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    i = torch.remainder(torch.floor(h), 6)
    f = h - torch.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    table = {"r": (v, q, p, p, t, v), "g": (t, v, v, q, p, p), "b": (p, p, t, v, v, q)}
    out = []
    for choices in table.values():
        # jnp.select: the first matching case, 0 where none matches.
        acc = torch.zeros_like(v)
        for k in range(5, -1, -1):
            acc = torch.where(i == k, choices[k], acc)
        out.append(acc)
    return torch.stack(out, dim=-1)


def rgb_to_hls(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HLS: H in degrees, L, S in [0, 1]."""
    x = _as_float(rgb)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    light = (maxc + minc) / 2.0
    delta = maxc - minc
    denom = torch.where(light <= 0.5, maxc + minc, 2.0 - maxc - minc)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    s = torch.where(delta == 0, torch.zeros_like(delta), delta / denom)
    return torch.stack([_hue(r, g, b, maxc, delta), light, s], dim=-1)


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    delta = 6.0 / 29.0
    # Where t > delta^3 > 0 the cube root is of a positive number.
    cbrt = t.clamp(min=0).pow(1.0 / 3.0)
    return torch.where(t > delta**3, cbrt, t / (3 * delta**2) + 4.0 / 29.0)


def _f_lab_inv(t: torch.Tensor) -> torch.Tensor:
    delta = 6.0 / 29.0
    return torch.where(t > delta, t**3, 3 * delta**2 * (t - 4.0 / 29.0))


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> CIELAB (L in [0, 100]); the sRGB gamma is linearized first."""
    x = _as_float(rgb)
    x = torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    xyz = torch.tensordot(x, _const(_RGB2XYZ, x).T, dims=([-1], [0]))
    xyz = xyz / _const(_WHITE, x)
    fx = _f_lab(xyz)
    L = 116.0 * fx[..., 1] - 16.0
    a = 500.0 * (fx[..., 0] - fx[..., 1])
    b = 200.0 * (fx[..., 1] - fx[..., 2])
    return torch.stack([L, a, b], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB -> sRGB in [0, 1] (inverse of :func:`rgb_to_lab`)."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_f_lab_inv(fx), _f_lab_inv(fy), _f_lab_inv(fz)], dim=-1)
    xyz = xyz * _const(_WHITE, xyz)
    rgb = torch.tensordot(xyz, _const(_XYZ2RGB, xyz).T, dims=([-1], [0]))
    rgb = rgb.clamp(0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1 / 2.4) - 0.055)
    return srgb.clamp(0.0, 1.0)


_CONVERSIONS = {
    ("RGB", "HSV"): rgb_to_hsv,
    ("HSV", "RGB"): hsv_to_rgb,
    ("RGB", "HLS"): rgb_to_hls,
    ("RGB", "LAB"): rgb_to_lab,
    ("LAB", "RGB"): lab_to_rgb,
    ("RGB", "BGR"): lambda x: x.flip(-1),
    ("BGR", "RGB"): lambda x: x.flip(-1),
    ("RGB", "RGB"): lambda x: x,
}


def convert_trichromatic(data: torch.Tensor, source: str, target: str) -> torch.Tensor:
    """Convert between trichromatic colour spaces (through RGB if needed)."""
    source, target = source.upper(), target.upper()
    if (source, target) in _CONVERSIONS:
        return _CONVERSIONS[(source, target)](data)
    if (source, "RGB") in _CONVERSIONS and ("RGB", target) in _CONVERSIONS:
        return _CONVERSIONS[("RGB", target)](_CONVERSIONS[(source, "RGB")](data))
    raise NotImplementedError(f"Conversion {source} -> {target} not supported.")


def to_monochromatic(rgb: torch.Tensor, key: str) -> torch.Tensor:
    """A scalar channel or feature of an RGB tensor: gray, red, green, blue,
    hue, saturation, value or norm."""
    key = key.lower()
    if key == "gray":
        return rgb_to_gray(rgb)
    if key in ("red", "green", "blue"):
        return rgb[..., ("red", "green", "blue").index(key)]
    if key in ("hue", "saturation", "value"):
        return rgb_to_hsv(rgb)[..., ("hue", "saturation", "value").index(key)]
    if key == "norm":
        return torch.linalg.vector_norm(_as_float(rgb), dim=-1)
    raise NotImplementedError(f"Monochromatic key {key!r} not supported.")
