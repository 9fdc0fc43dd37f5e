"""Finite-difference stencils on tensors.

Counterpart of :mod:`darsia_tpu.utils.derivatives`.  ``backward_diff``
appends an edge copy (last entry 0), ``forward_diff`` prepends one (first
entry 0); ``laplace`` is the symmetrized heterogeneous div(D grad) with those
closures; ``fv_laplace`` is the zero-flux finite-volume operator the solver
stack uses.  The first ``dim`` axes are spatial, any further axes are batch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["backward_diff", "forward_diff", "fv_laplace", "laplace"]


def _check_axis(axis: int, dim: int) -> None:
    if not axis < dim:
        raise ValueError("axis must be smaller than dimension")


def backward_diff(
    img: torch.Tensor, axis: int, dim: int = 2, h: Optional[float] = None
) -> torch.Tensor:
    """Difference ``img[i+1] - img[i]`` with zero closure at the top end."""
    _check_axis(axis, dim)
    out = torch.diff(img, dim=axis, append=img.narrow(axis, img.shape[axis] - 1, 1))
    return out if h is None else out / h


def forward_diff(
    img: torch.Tensor, axis: int, dim: int = 2, h: Optional[float] = None
) -> torch.Tensor:
    """Difference ``img[i] - img[i-1]`` with zero closure at the bottom end."""
    _check_axis(axis, dim)
    out = torch.diff(img, dim=axis, prepend=img.narrow(axis, 0, 1))
    return out if h is None else out / h


def laplace(
    img: torch.Tensor,
    axis: Optional[int] = None,
    dim: int = 2,
    h: Optional[float] = None,
    diffusion_coeff: Union[torch.Tensor, float] = 1,
) -> torch.Tensor:
    """Symmetrized heterogeneous Laplacian ``0.5 (D- D D+ + D+ D D-)``.

    Its boundary closures differ from :func:`fv_laplace`'s (the boundary
    rows carry half a one-sided second difference instead of a zero flux),
    as in the JAX package; the solver stack uses :func:`fv_laplace`.
    """
    axes = range(dim) if axis is None else [axis]
    out = torch.zeros_like(img)
    for ax in axes:
        out = out + 0.5 * (
            backward_diff(diffusion_coeff * forward_diff(img, ax, dim, h), ax, dim, h)
            + forward_diff(diffusion_coeff * backward_diff(img, ax, dim, h), ax, dim, h)
        )
    return out


def fv_laplace(
    img: torch.Tensor,
    axis: Optional[int] = None,
    dim: int = 2,
    h: Optional[float] = None,
    diffusion_coeff: Union[torch.Tensor, float] = 1.0,
) -> torch.Tensor:
    """Finite-volume ``div(D grad)`` with zero-flux (Neumann) boundaries.

    Interior face fluxes ``D * diff(img)`` padded by zero boundary fluxes and
    differenced again: for constant D the edge-replicated (2*dim+1)-point
    Laplacian.  A diffusion field is broadcast to the image and sampled on
    interior faces by the arithmetic mean of the two cells.
    """
    axes = range(dim) if axis is None else [axis]
    d_is_field = isinstance(diffusion_coeff, torch.Tensor) and diffusion_coeff.dim() > 0
    if d_is_field:
        diffusion_coeff = diffusion_coeff.to(img.dtype).broadcast_to(img.shape)
    out = torch.zeros_like(img)
    for ax in axes:
        grad = torch.diff(img, dim=ax)
        if d_is_field:
            n = img.shape[ax]
            lo = diffusion_coeff.narrow(ax, 0, n - 1)
            hi = diffusion_coeff.narrow(ax, 1, n - 1)
            flux = 0.5 * (lo + hi) * grad
        else:
            flux = diffusion_coeff * grad
        zshape = list(flux.shape)
        zshape[ax] = 1
        zero = torch.zeros(zshape, dtype=flux.dtype, device=flux.device)
        out = out + torch.diff(torch.cat([zero, flux, zero], dim=ax), dim=ax)
    return out if h is None else out / (h * h)
