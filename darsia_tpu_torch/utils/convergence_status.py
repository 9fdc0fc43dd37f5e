"""Convergence status enum (counterpart of
:mod:`darsia_tpu.utils.convergence_status`)."""

from __future__ import annotations

from enum import Enum

__all__ = ["ConvergenceStatus"]


class ConvergenceStatus(str, Enum):
    """Status of an iterative solve."""

    CONVERGED = "converged"
    NOT_CONVERGED = "not_converged"
    DIVERGED = "diverged"
    IN_PROGRESS = "in_progress"
