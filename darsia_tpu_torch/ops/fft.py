"""FFT phase correlation, batched over windows.

Counterpart of :mod:`darsia_tpu.ops.fft` (the prepared-reference lane).  The
JAX package vmaps one window; here a leading batch axis is written out:
windows are ``(N, H, W)`` and spectra ``(N, H, W // 2 + 1)``.
"""

from __future__ import annotations

import torch

__all__ = ["phase_correlation_prepared", "prepare_phase_reference"]


def _hann(n: int, device) -> torch.Tensor:
    # Symmetric Hann window, as jnp.hanning: periodic=False.  The two differ
    # by at most one f32 ulp (2.4e-7), which moves shifts far below the
    # 1e-3 px the parity tests allow.
    if n <= 1:
        return torch.ones(1, dtype=torch.float32, device=device)
    return torch.hann_window(n, periodic=False, dtype=torch.float32, device=device)


def _window(shape: tuple, device) -> torch.Tensor:
    H, W = shape
    return _hann(H, device)[:, None] * _hann(W, device)[None, :]


def _taper(x: torch.Tensor) -> torch.Tensor:
    """Remove each window's mean and apply the Hann taper."""
    x = x.to(torch.float32)
    window = _window(tuple(x.shape[-2:]), x.device)
    return (x - x.mean(dim=(-2, -1), keepdim=True)) * window


def prepare_phase_reference(src: torch.Tensor) -> torch.Tensor:
    """F(windowed reference) of ``(N, H, W)`` windows, for repeated correlations."""
    return torch.fft.rfft2(_taper(src))


def _parabolic_subpixel(r: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """1-dof parabolic refinement of per-window argmax locations.

    Args:
        r: (N, H, W) correlation surfaces.
        py, px: (N,) integer peak rows/cols.

    Returns:
        (N, 2) refined (row, col) float32 positions.

    """
    N, H, W = r.shape
    n = torch.arange(N, device=r.device)

    def fit(center, minus, plus):
        denom = minus - 2.0 * center + plus
        offset = torch.where(
            denom.abs() > 1e-12, 0.5 * (minus - plus) / denom, torch.zeros_like(denom)
        )
        return offset.clamp(-0.5, 0.5)

    c = r[n, py, px]
    dy = fit(c, r[n, (py - 1) % H, px], r[n, (py + 1) % H, px])
    dx = fit(c, r[n, py, (px - 1) % W], r[n, py, (px + 1) % W])
    return torch.stack([py.to(torch.float32) + dy, px.to(torch.float32) + dx], dim=1)


def phase_correlation_prepared(
    ref_spectrum: torch.Tensor,
    src: torch.Tensor,
    shape: tuple,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-window shift (row, col) of ``src`` against a prepared reference.

    Args:
        ref_spectrum: (N, H, W // 2 + 1) from :func:`prepare_phase_reference`.
        src: (N, H, W) windows.
        shape: (H, W).

    Returns:
        ``(shifts (N, 2), quality (N,))``: signed subpixel shifts and the
        correlation peak clipped to [0, 1].

    """
    H, W = shape
    Fb = torch.fft.rfft2(_taper(src))
    cross = ref_spectrum * torch.conj(Fb)
    cross = cross / (cross.abs() + eps)
    r = torch.fft.irfft2(cross, s=(H, W))
    flat = r.reshape(r.shape[0], -1)
    # torch.argmax returns the first maximal index, as jnp.argmax does, so
    # ties resolve to the same peak.
    flat_peak = flat.argmax(dim=1)
    refined = _parabolic_subpixel(r, flat_peak // W, flat_peak % W)
    half = torch.tensor([H / 2, W / 2], dtype=torch.float32, device=r.device)
    size = torch.tensor([H, W], dtype=torch.float32, device=r.device)
    shift = torch.where(refined > half, refined - size, refined)
    quality = flat.gather(1, flat_peak[:, None])[:, 0].clamp(0.0, 1.0)
    return shift, quality
