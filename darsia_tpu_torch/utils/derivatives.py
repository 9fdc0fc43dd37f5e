"""Finite-volume derivatives (the part the H1 solver uses).

Counterpart of :mod:`darsia_tpu.utils.derivatives`.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fv_laplace"]


def fv_laplace(
    img: torch.Tensor,
    dim: int = 2,
    h: Optional[float] = None,
    diffusion_coeff: float = 1.0,
) -> torch.Tensor:
    """Finite-volume ``div(D grad)`` with zero-flux boundaries, constant D.

    Interior face fluxes ``D * diff(img)`` padded by zero boundary fluxes and
    differenced again: the edge-replicated 5-point Laplacian in 2-D.
    """
    if isinstance(diffusion_coeff, torch.Tensor) and diffusion_coeff.dim() > 0:
        raise NotImplementedError("heterogeneous diffusion is not ported yet")
    out = torch.zeros_like(img)
    for ax in range(dim):
        flux = diffusion_coeff * torch.diff(img, dim=ax)
        zshape = list(flux.shape)
        zshape[ax] = 1
        zero = torch.zeros(zshape, dtype=flux.dtype, device=flux.device)
        out = out + torch.diff(torch.cat([zero, flux, zero], dim=ax), dim=ax)
    return out if h is None else out / (h * h)
