"""Kernel interpolation models: color -> value regression.

Counterpart of :mod:`darsia_tpu.signals.models.kernelinterpolation`.  The
dense kernel system over the unique supports is inverted on the host in
float64 with its relative ridge, once per update, as in the JAX package;
application is the weighted kernel combination of
:mod:`darsia_tpu_torch.utils.kernels` on the signal's device.

Both run in float64, where the JAX package builds the kernel matrix and
evaluates the combination in float32 (ROADMAP.md Queue 3, reference fault
23): clustered colours make the matrix nearly singular (condition ~1e8
under the 1e-8 ridge), the weights reach ~1e7, and a float32 evaluation's
rounding (~0.5) would swamp the interpolant.  The output is float32.
"""

from __future__ import annotations

from typing import Optional
from warnings import warn

import numpy as np
import torch

from ...utils.kernels import BaseKernel
from .basemodel import Model

__all__ = ["KernelInterpolation", "AdvancedKernelInterpolation"]


class KernelInterpolation(Model):
    """Kernel-based interpolation of (support color -> value) samples."""

    def __init__(
        self,
        kernel: BaseKernel,
        supports: Optional[np.ndarray] = None,
        values: Optional[np.ndarray] = None,
    ) -> None:
        self.kernel = kernel
        self.supports = None
        self.values = None
        self.num_supports = 0
        self.interpolation_weights = None
        self.update(kernel=kernel, supports=supports, values=values)

    def update(
        self,
        kernel: Optional[BaseKernel] = None,
        supports=None,
        values=None,
        append: bool = False,
    ) -> None:
        if isinstance(supports, list):
            supports = np.array(supports)
        if isinstance(values, list):
            values = np.array(values)
        if kernel is not None:
            self.kernel = kernel
        if supports is not None:
            if self.supports is None or not append:
                self.supports = supports.astype(np.float32)
            else:
                self.supports = np.vstack((self.supports, supports)).astype(
                    np.float32
                )
            self.num_supports = self.supports.shape[0]
            self._Xinv = None
        if values is not None:
            if self.values is None or not append:
                self.values = np.asarray(values)
            else:
                self.values = np.hstack((self.values, values))
        if self.supports is not None and self.values is not None:
            self.update_interpolation()
        else:
            warn("No input data given. Interpolation weights not updated.")

    def update_kernel(self, kernel: BaseKernel) -> None:
        """Swap the kernel and refactor the interpolation system
        (reference kernelinterpolation.py:99-106)."""
        self.kernel = kernel
        self._Xinv = None
        if self.supports is not None and self.values is not None:
            self.update_interpolation()

    def setup_kernel_problem(self) -> None:
        """Reduce to unique supports and factor the dense kernel matrix."""
        assert len(self.values) == self.num_supports, (
            f"Input data not compatible: {len(self.values)} != {self.num_supports}."
        )
        self.supports, indices, counts = np.unique(
            np.round(self.supports, decimals=5),
            return_index=True,
            return_counts=True,
            axis=0,
        )
        if not np.allclose(counts, 1):
            warn(
                f"Supports are not unique. {int(np.sum(counts - 1))} supports "
                "were removed."
            )
        self.num_supports = self.supports.shape[0]
        self.values = self.values[indices]

        # Dense kernel matrix over supports (vectorized pairwise evaluation).
        S = torch.from_numpy(np.asarray(self.supports, dtype=np.float64))
        X = self.kernel(S[:, None, :], S[None, :, :]).numpy()
        # Near-duplicate supports make X numerically singular; a small
        # relative ridge keeps the interpolant bounded (kernel ridge
        # regression limit) instead of amplifying noise.
        n = X.shape[0]
        ridge = 1e-8 * np.trace(X) / max(n, 1)
        self._Xinv = np.linalg.inv(X + ridge * np.eye(n))

    def update_interpolation(self) -> None:
        if getattr(self, "_Xinv", None) is None:
            self.setup_kernel_problem()
        self.interpolation_weights = self._Xinv @ self.values

    def update_model_parameters(self, parameters, dofs=None) -> None:
        if dofs is not None and "supports" in dofs:
            raise ValueError("Supports cannot be updated. Use update method.")
        if dofs is None or dofs == "all" or set(dofs) == {"kernel", "values"}:
            self.update(
                kernel=parameters[0], values=parameters[1 : 1 + self.num_supports]
            )
        elif set(dofs) == {"kernel"}:
            self.update(kernel=parameters[0])
        elif set(dofs) == {"values"}:
            self.update(values=parameters[: self.num_supports])
        else:
            raise ValueError("Invalid dofs.")

    def call_array(self, signal: torch.Tensor) -> torch.Tensor:
        if self.supports is None or self.interpolation_weights is None:
            return torch.zeros(signal.shape[:1], dtype=torch.float32, device=signal.device)
        return self.kernel.linear_combination(
            signal.to(torch.float64),
            np.asarray(self.supports, dtype=np.float64),
            np.asarray(self.interpolation_weights, dtype=np.float64),
        ).to(torch.float32)


class AdvancedKernelInterpolation(KernelInterpolation):
    """Kernel interpolation with a fixed base set of supports + updates."""

    def __init__(self, kernel: BaseKernel) -> None:
        super().__init__(kernel=kernel)
        self.fixed_supports = None
        self.fixed_values = None
        self.num_fixed_supports = 0

    def fix_supports(self, supports, values) -> None:
        """Pin a base set of (support, value) pairs kept across updates."""
        self.fixed_supports = np.asarray(supports, dtype=np.float32)
        self.fixed_values = np.asarray(values)
        self.num_fixed_supports = self.fixed_supports.shape[0]

    def update(self, kernel=None, supports=None, values=None, append=False) -> None:
        if supports is not None and self.fixed_supports is not None:
            supports = np.vstack((self.fixed_supports, np.asarray(supports)))
            values = np.hstack((self.fixed_values, np.asarray(values)))
        super().update(kernel=kernel, supports=supports, values=values, append=append)

    def update_advanced(
        self,
        fixed_supports=None,
        fixed_values=None,
        variable_supports=None,
        variable_values=None,
    ) -> None:
        """Partial update of the fixed/variable support split
        (reference kernelinterpolation.py:208-262)."""
        if fixed_supports is not None or fixed_values is not None:
            self.fix_supports(
                self.fixed_supports if fixed_supports is None else fixed_supports,
                self.fixed_values if fixed_values is None else fixed_values,
            )
        if variable_supports is not None:
            self.variable_supports = np.asarray(
                variable_supports, dtype=np.float32
            )
            self.num_variable_supports = self.variable_supports.shape[0]
        if variable_values is not None:
            self.variable_values = np.asarray(variable_values)
        var_supports = getattr(self, "variable_supports", None)
        var_values = getattr(self, "variable_values", None)
        if var_supports is not None and var_values is not None:
            # Rebuild from the fixed base + current variable set (no append:
            # super().update prepends the fixed supports itself).
            self.update(supports=var_supports, values=var_values)

    @property
    def num_variable_supports(self) -> int:
        return getattr(self, "_num_variable_supports", 0)

    @num_variable_supports.setter
    def num_variable_supports(self, value: int) -> None:
        self._num_variable_supports = int(value)

    def update_variable_model_parameters(self, parameters) -> None:
        """Calibration hook: new values on the variable supports only
        (reference kernelinterpolation.py:264-270)."""
        parameters = np.asarray(parameters)
        if len(parameters) != self.num_variable_supports:
            raise ValueError(
                f"Expected {self.num_variable_supports} parameters, got "
                f"{len(parameters)}."
            )
        self.update_advanced(variable_values=parameters)
