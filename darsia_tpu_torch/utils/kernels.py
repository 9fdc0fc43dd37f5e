"""Kernels for kernel-interpolation models.

Counterpart of :mod:`darsia_tpu.utils.kernels`.  The weighted combination
over supports is one matrix product on the signal's device, in float64 for
a float64 signal and in float32 otherwise (TF32 is off package-wide, so a
float32 product is a full one); for a large image the (pixels, supports)
temporary is built in row blocks of at most ``BLOCK_BYTES``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

__all__ = ["BaseKernel", "LinearKernel", "GaussianKernel"]

#: Largest (rows, supports) temporary of one block.
BLOCK_BYTES = 256 * 2**20


def _real(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a real tensor: float64 stays float64 unless ``dtype`` says
    otherwise, anything else becomes float32."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    if dtype is None:
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(device=device or x.device, dtype=dtype)


class BaseKernel(ABC):
    """Kernel interface: pointwise evaluation + weighted combination."""

    @abstractmethod
    def __call__(self, x, y): ...

    @abstractmethod
    def linear_combination(self, signal, supports, interpolation_weights): ...


class LinearKernel(BaseKernel):
    """Linear kernel k(x, y) = <x, y> + a."""

    def __init__(self, a: float = 0.0) -> None:
        self.a = a

    def __call__(self, x, y):
        return torch.sum(_real(x) * _real(y), dim=-1) + self.a

    def linear_combination(self, signal, supports, interpolation_weights):
        """sum_n w_n (<signal, s_n> + a) = signal @ (S^T w) + a * sum w."""
        signal = _real(signal)
        supports = _real(supports, signal.device, signal.dtype)
        w = _real(interpolation_weights, signal.device, signal.dtype)
        combined = supports.T @ w  # (C,)
        return torch.tensordot(signal, combined, dims=([-1], [0])) + self.a * torch.sum(w)


class GaussianKernel(BaseKernel):
    """Gaussian RBF kernel k(x, y) = exp(-gamma ||x - y||^2)."""

    def __init__(self, gamma: float = 1.0) -> None:
        self.gamma = float(gamma)

    def __call__(self, x, y):
        diff = _real(x) - _real(y)
        return torch.exp(-self.gamma * torch.sum(diff * diff, dim=-1))

    def linear_combination(self, signal, supports, interpolation_weights):
        """Pairwise squared distances through one matmul, then a weighted
        exp-sum, in row blocks."""
        signal = _real(signal)
        supports = _real(supports, signal.device, signal.dtype)
        w = _real(interpolation_weights, signal.device, signal.dtype)
        flat = signal.reshape(-1, signal.shape[-1])
        s_sq = torch.sum(supports * supports, dim=-1)[None, :]
        rows = max(1, BLOCK_BYTES // (flat.element_size() * max(supports.shape[0], 1)))
        out = torch.empty(flat.shape[0], dtype=flat.dtype, device=flat.device)
        for start in range(0, flat.shape[0], rows):
            block = flat[start : start + rows]
            # ||x - s||^2 = ||x||^2 - 2 x.s + ||s||^2: the x.s term is a matmul.
            x_sq = torch.sum(block * block, dim=-1, keepdim=True)
            d2 = torch.clamp(x_sq - 2.0 * (block @ supports.T) + s_sq, min=0.0)
            out[start : start + rows] = torch.exp(-self.gamma * d2) @ w
        return out.reshape(signal.shape[:-1])
