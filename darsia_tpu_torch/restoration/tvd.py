"""Total-variation denoising front-end.

Counterpart of :mod:`darsia_tpu.restoration.tvd`.  Methods:

* "chambolle": the dual-projection loop of :mod:`darsia_tpu_torch.ops.tv`.
* "anisotropic bregman" / "isotropic bregman": split-Bregman with the skimage
  weight convention (smaller weight = more denoising, ``mu = 1 / weight``).
* "heterogeneous bregman": split-Bregman with heterogeneous weights
  (``mu = weight``).
"""

from __future__ import annotations

import torch

from ..image.image import as_tensor
from ..ops.tv import chambolle_tvd
from ..utils.dtype import convert_dtype
from .split_bregman_tvd import split_bregman_tvd

__all__ = ["TVD", "tvd"]


class TVD:
    """Total variation denoising interface.

    Keyword arguments, the first four optionally prefixed by ``key``:
    ``method``, ``weight``, ``max_num_iter``, ``eps``; ``omega`` and
    ``regularization`` (heterogeneous bregman only); ``device`` (where numpy
    inputs go, the CUDA card by default); anything else is passed on to
    :func:`split_bregman_tvd`.
    """

    def __init__(self, key: str = "", **kwargs) -> None:
        self.method = kwargs.pop(key + "method", "chambolle").lower()
        if self.method == "heterogeneous bregman":
            self.omega = kwargs.pop("omega", 1)
            self.regularization = kwargs.get("regularization", 1.0)
        self.weight = kwargs.pop(key + "weight", 0.1)
        self.max_num_iter = kwargs.pop(key + "max_num_iter", 200)
        self.eps = kwargs.pop(key + "eps", 2e-4)
        self.device = kwargs.pop("device", None)
        self.kwargs = kwargs

    def __call__(self, img):
        if hasattr(img, "img"):
            img_copy = img.copy()
            img_copy.img = self._tvd_array(img.img)
            return img_copy
        return self._tvd_array(as_tensor(img, self.device))

    def _tvd_array(self, img: torch.Tensor) -> torch.Tensor:
        work = convert_dtype(img, torch.float32)
        if self.method == "chambolle":
            out = chambolle_tvd(
                work, weight=self.weight, eps=self.eps, max_num_iter=self.max_num_iter
            )
        elif self.method in ("anisotropic bregman", "isotropic bregman"):
            out = split_bregman_tvd(
                work,
                mu=1.0 / self.weight,
                max_num_iter=self.max_num_iter,
                eps=self.eps,
                isotropic=self.method.startswith("isotropic"),
                **self.kwargs,
            )
        elif self.method == "heterogeneous bregman":
            out = split_bregman_tvd(
                work,
                mu=self.weight,
                omega=self.omega,
                ell=self.regularization,
                max_num_iter=self.max_num_iter,
                eps=self.eps,
                **self.kwargs,
            )
        else:
            raise ValueError(f"Method {self.method} not supported.")
        return convert_dtype(out, img.dtype)


def tvd(img, method: str = "chambolle", **kwargs):
    """Functional TVD (method + kwargs as in :class:`TVD`)."""
    return TVD(method=method, **kwargs)(img)
