"""Chambolle (2004) TV denoising as a dual-projection loop on tensors.

Counterpart of :mod:`darsia_tpu.ops.tv` (A. Chambolle, "An algorithm for
total variation minimization and applications", JMIV 2004).  All axes of the
image are spatial (any rank).  The stopping rule is computed on the device
and read once per iteration (:func:`darsia_tpu_torch.ops.solvers.iterate_while`).
"""

from __future__ import annotations

import torch

from .solvers import iterate_while

__all__ = ["chambolle_tvd"]


def _zeros_slab(like: torch.Tensor, ax: int) -> torch.Tensor:
    shape = list(like.shape)
    shape[ax] = 1
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _divergence(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """Divergence of the dual field ``p`` of shape (ndim, *spatial)."""
    d = -torch.sum(p, dim=0)
    for ax in range(ndim):
        comp = p[ax]
        shifted = comp.narrow(ax, 0, comp.shape[ax] - 1)
        d = d + torch.cat([_zeros_slab(comp, ax), shifted], dim=ax)
    return d


def _gradient(out: torch.Tensor, ndim: int) -> torch.Tensor:
    """Forward-difference gradient with zero closure, shape (ndim, *spatial)."""
    comps = []
    for ax in range(ndim):
        diff = torch.diff(out, dim=ax)
        comps.append(torch.cat([diff, _zeros_slab(out, ax)], dim=ax))
    return torch.stack(comps, dim=0)


def _chambolle(
    image: torch.Tensor,
    weight: float,
    eps: float,
    max_num_iter: int,
) -> tuple:
    """The denoised image and the number of iterations taken."""
    image = image.to(torch.float32)
    ndim = image.dim()
    tau = 1.0 / (2.0 * ndim)

    def energy_and_step(p):
        d = _divergence(p, ndim)
        out = image + d
        g = _gradient(out, ndim)
        norm = torch.sqrt(torch.sum(g**2, dim=0))[None]
        E = torch.sum(d**2) + weight * torch.sum(norm)
        p_new = (p - tau * g) / (1.0 + (tau / weight) * norm)
        return p_new, out, E / image.numel()

    p0 = torch.zeros((ndim, *image.shape), dtype=torch.float32, device=image.device)
    # The first iteration establishes E_init.
    p, out, E_init = energy_and_step(p0)

    def cond(state, it):
        _, _, E_prev, E_curr = state
        if it <= 1:
            return True
        return (E_prev - E_curr).abs() >= eps * E_init

    def body(state, it):
        p, _, _, E_curr = state
        p_new, out, E = energy_and_step(p)
        return (p_new, out, E_curr, E)

    (_, out, _, _), taken = iterate_while(
        cond, body, (p, out, E_init + 1.0, E_init), max_num_iter, start=1
    )
    return out, taken


def chambolle_tvd(
    image: torch.Tensor,
    weight: float = 0.1,
    eps: float = 2e-4,
    max_num_iter: int = 200,
) -> torch.Tensor:
    """TV denoising by Chambolle's dual projection.

    Args:
        image: float tensor (any rank; all axes treated as spatial).
        weight: denoising weight (larger = more denoising).
        eps: relative tolerance on the energy decrement.
        max_num_iter: iteration cap.

    """
    return _chambolle(image, weight, eps, max_num_iter)[0]
