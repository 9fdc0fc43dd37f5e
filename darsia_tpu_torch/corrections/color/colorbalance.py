"""Color and white balances fit to swatch pairs.

Counterpart of :mod:`darsia_tpu.corrections.color.colorbalance`.  The fits
are the JAX package's closed-form least-squares solves, in float64 numpy on
the host; a balance applies as ``img @ B (+ t)`` in float32 on the tensor's
device (a numpy input is computed on the CPU and returned as numpy).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Literal

import numpy as np
import torch

__all__ = [
    "AdaptiveBalance",
    "AffineBalance",
    "BaseBalance",
    "ColorBalance",
    "WhiteBalance",
    "affine_balance",
    "color_balance",
    "white_balance",
]


def _affine(img, scaling: np.ndarray, shift=None):
    """``img @ scaling (+ shift)`` in float32 on ``img``'s device."""
    is_numpy = not isinstance(img, torch.Tensor)
    x = torch.as_tensor(np.asarray(img, dtype=np.float32) if is_numpy else img)
    x = x.to(torch.float32)
    out = x @ torch.as_tensor(np.asarray(scaling, dtype=np.float32), device=x.device)
    if shift is not None:
        out = out + torch.as_tensor(np.asarray(shift, dtype=np.float32), device=x.device)
    return out.numpy() if is_numpy else out


class BaseBalance(ABC):
    """Base class of color balances: ``img @ balance_scaling (+ shift)``."""

    @abstractmethod
    def find_balance(self, swatches_src: np.ndarray, swatches_dst) -> None: ...

    def apply_balance(self, img):
        return _affine(img, self.balance_scaling)

    def __call__(self, img, swatches_src, swatches_dst):
        self.find_balance(swatches_src, swatches_dst)
        return self.apply_balance(img)


def _pairs(swatches_src, swatches_dst) -> tuple[np.ndarray, np.ndarray]:
    S = np.asarray(swatches_src, dtype=float).reshape(-1, 3)
    D = np.asarray(swatches_dst, dtype=float).reshape(-1, 3)
    return S, D


class ColorBalance(BaseBalance):
    """Linear 3x3 balance: the exact LS solve of ``min ||S B - D||_F``."""

    def __init__(self) -> None:
        self.balance_scaling: np.ndarray = np.eye(3)

    def find_balance(self, swatches_src: np.ndarray, swatches_dst) -> None:
        S, D = _pairs(swatches_src, swatches_dst)
        self.balance_scaling, *_ = np.linalg.lstsq(S, D, rcond=None)


class WhiteBalance(BaseBalance):
    """Diagonal balance: per-channel closed-form LS."""

    def __init__(self) -> None:
        self.balance_scaling: np.ndarray = np.eye(3)

    def find_balance(self, swatches_src: np.ndarray, swatches_dst) -> None:
        S, D = _pairs(swatches_src, swatches_dst)
        diag = np.array(
            [
                (S[:, i] @ D[:, i]) / (S[:, i] @ S[:, i]) if (S[:, i] @ S[:, i]) > 0 else 1.0
                for i in range(3)
            ]
        )
        self.balance_scaling = np.diag(diag)


class AffineBalance(BaseBalance):
    """Affine balance ``x @ B + t``: closed form via the augmented LS."""

    def __init__(self) -> None:
        self.balance_scaling: np.ndarray = np.eye(3)
        self.balance_translation: np.ndarray = np.zeros(3)

    def find_balance(self, swatches_src: np.ndarray, swatches_dst) -> None:
        S, D = _pairs(swatches_src, swatches_dst)
        S_aug = np.hstack([S, np.ones((S.shape[0], 1))])
        sol, *_ = np.linalg.lstsq(S_aug, D, rcond=None)
        self.balance_scaling = sol[:3]
        self.balance_translation = sol[3]

    def apply_balance(self, img):
        return _affine(img, self.balance_scaling, self.balance_translation)


class AdaptiveBalance(AffineBalance):
    """Incrementally composed balance (diagonal, linear or affine updates)."""

    def reset(self) -> None:
        self.balance_scaling = np.eye(3)
        self.balance_translation = np.zeros(3)

    def find_balance(
        self,
        swatches_src: np.ndarray,
        swatches_dst,
        mode: Literal["diagonal", "linear", "affine"] = "affine",
    ) -> None:
        # Precondition with the current balance (float32, as applied), then
        # compose: x B_prev B_new + (t_prev B_new + t_new).
        src_pre = self.apply_balance(np.asarray(swatches_src, dtype=float).reshape(-1, 3))
        if mode == "diagonal":
            balance = WhiteBalance()
        elif mode == "linear":
            balance = ColorBalance()
        elif mode == "affine":
            balance = AffineBalance()
        else:
            raise ValueError(f"mode {mode} not supported.")
        balance.find_balance(src_pre, swatches_dst)
        self.balance_scaling = self.balance_scaling @ balance.balance_scaling
        self.balance_translation = self.balance_translation @ balance.balance_scaling
        if mode == "affine":
            self.balance_translation = self.balance_translation + balance.balance_translation


def color_balance(img, swatches_src, swatches_dst):
    """One-shot linear color balance."""
    return ColorBalance()(img, swatches_src, swatches_dst)


def white_balance(img, swatches_src, swatches_dst):
    """One-shot white balance."""
    return WhiteBalance()(img, swatches_src, swatches_dst)


def affine_balance(img, swatches_src, swatches_dst):
    """One-shot affine balance."""
    return AffineBalance()(img, swatches_src, swatches_dst)
