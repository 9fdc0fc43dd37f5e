"""Anderson acceleration for fixed-point iterations.

Counterpart of :mod:`darsia_tpu.utils.andersonacceleration`.  Two
implementations share the same Type-II mixing math, as there:

- :class:`AndersonAcceleration`: the host (numpy) class, copied; one call
  per outer step, exact lstsq mixing.  The solvers' host loops use it.
- :func:`anderson_init` / :func:`anderson_mix`: the same mixing on tensors
  of the iterate's device, with the JAX package's static shapes: a
  ridge-augmented tall-skinny QR over the whole depth-sized history, where
  columns not yet filled are zero and get (regularized) zero weights.  QR,
  not normal equations: in float32 the normal equations slowed Newton down
  (72 against 51 iterations on the 128^2 weighted problem, JAX package),
  while QR follows the host lstsq.  The iteration counter is a Python int,
  so nothing is read from the device.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["AndersonAcceleration", "anderson_init", "anderson_mix"]


def anderson_init(dimension: int, depth: int, dtype=torch.float32, device=None) -> dict:
    """Zero Anderson state for :func:`anderson_mix`: residual-difference
    history ``F`` and iterate-difference history ``G`` (``(depth,
    dimension)``, rows are ring-buffer slots), the previous residual and
    iterate, and the iteration counter."""
    zeros = dict(dtype=dtype, device=device)
    return {
        "F": torch.zeros((depth, dimension), **zeros),
        "G": torch.zeros((depth, dimension), **zeros),
        "fkm1": torch.zeros(dimension, **zeros),
        "gkm1": torch.zeros(dimension, **zeros),
        "iteration": 0,
    }


def anderson_mix(
    state: dict,
    gk: torch.Tensor,
    fk: torch.Tensor,
    restart: Optional[int] = None,
    reg: float = 1e-5,
):
    """One Anderson(depth) mixing step.

    Args:
        state: from :func:`anderson_init` (or a previous call); its history
            buffers are updated in place.
        gk: current fixed-point application ``g(x_k)`` (flat vector).
        fk: current residual ``g(x_k) - x_k`` (flat vector).
        restart: optional restart period (counter wraps, buffers reset).
        reg: ridge regularization relative to the largest history-column
            norm (guards empty ring-buffer slots and near-collinear
            histories).

    Returns:
        ``(state_next, x_next)``: the updated history and the mixed iterate.
    """
    F, G = state["F"], state["G"]
    depth = F.shape[0]
    it = state["iteration"]
    if restart is not None:
        it = it % int(restart)
    if it == 0:
        F.zero_()
        G.zero_()
        x_next = gk
    else:
        col = (it - 1) % depth
        F[col] = fk - state["fkm1"]
        G[col] = gk - state["gkm1"]
        # Type-II mixing: gamma = argmin ||F^T gamma - fk|| over the history,
        # via the ridge-augmented tall-skinny QR.
        colnorm = torch.sqrt(torch.sum(F * F, dim=1))
        lam = reg * torch.max(colnorm) + 1e-30
        eye = torch.eye(depth, dtype=F.dtype, device=F.device)
        A = torch.cat([F.T, lam * eye], dim=0)
        b = torch.cat([fk, fk.new_zeros(depth)])
        Q, R = torch.linalg.qr(A)
        gamma = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]
        x_next = gk - G.T @ gamma
    state_next = {
        "F": F,
        "G": G,
        "fkm1": fk,
        "gkm1": gk,
        "iteration": state["iteration"] + 1,
    }
    return state_next, x_next


class AndersonAcceleration:
    """Anderson mixing of a fixed-point iteration.

    Args:
        dimension: flat dimension of the iterate (or tuple shape).
        depth: mixing depth (number of previous iterates).
        restart: optional restart period.

    """

    def __init__(
        self,
        dimension: Optional[Union[int, tuple]] = None,
        depth: int = 5,
        restart: Optional[int] = None,
    ) -> None:
        if isinstance(dimension, tuple):
            self._shape = dimension
            dimension = int(np.prod(dimension))
        elif dimension is not None:
            self._shape = (dimension,)
        else:
            # Lazy dimension (reference parity): sized on first call.
            self._shape = None
        self.dimension = dimension
        self.depth = depth
        self.restart = restart
        self.reset()

    def reset(self) -> None:
        self._fkm1: Optional[np.ndarray] = None
        self._gkm1: Optional[np.ndarray] = None
        if self.dimension is not None:
            self._F = np.zeros((self.dimension, self.depth))
            self._G = np.zeros((self.dimension, self.depth))
        else:
            self._F = None
            self._G = None
        self._iteration = 0

    def __call__(self, gk: np.ndarray, fk: np.ndarray, iteration: Optional[int] = None):
        """Mix the next iterate.

        Args:
            gk: current fixed-point application g(x_k).
            fk: current residual f(x_k) = g(x_k) - x_k.
            iteration: explicit iteration counter (internal if omitted).

        Returns:
            accelerated iterate (same shape as input).

        """
        shape = np.asarray(gk).shape
        gk = np.asarray(gk).ravel()
        fk = np.asarray(fk).ravel()
        if self.dimension is None:
            self.dimension = gk.size
            self._shape = (gk.size,)
            self.reset()
        if iteration is None:
            iteration = self._iteration
        if self.restart is not None:
            iteration = iteration % self.restart

        if iteration == 0:
            self._F[:] = 0.0
            self._G[:] = 0.0
            xkp1 = gk
        else:
            mk = min(iteration, self.depth)
            col = (iteration - 1) % self.depth
            self._F[:, col] = fk - self._fkm1
            self._G[:, col] = gk - self._gkm1
            cols = [(iteration - 1 - j) % self.depth for j in range(mk)]
            F = self._F[:, cols]
            G = self._G[:, cols]
            gamma, *_ = np.linalg.lstsq(F, fk, rcond=None)
            xkp1 = gk - G @ gamma

        self._fkm1 = fk.copy()
        self._gkm1 = gk.copy()
        self._iteration += 1
        return xkp1.reshape(shape)
