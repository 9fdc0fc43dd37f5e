"""Resize of physical images.

Counterpart of :mod:`darsia_tpu.restoration.resize`: resampling runs on the image's device through
:func:`darsia_tpu_torch.ops.resize.resize_array`, with optional
integral-preserving ("conservative") rescaling for extensive quantities.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..image.image import as_tensor
from ..ops.resize import resize_array
from ..utils.dtype import convert_dtype
from ..utils.npz import load_npz

__all__ = ["Resize", "equalize_voxel_size", "resize", "uniform_refinement"]


class Resize:
    """Resize operator for 2-D images and tensors.

    Args:
        ref_image: image whose voxel shape is the target.
        shape: target shape (matrix indexing).
        fx / fy: resize factors along Cartesian x / y.
        interpolation: "inter_area" (default) | "inter_linear" |
            "inter_nearest".
        dtype: optional dtype conversion before resizing.
        key: kwargs prefix (e.g. "restoration ") for config-driven setup.
        device: where an input that is not an Image goes (default: a tensor
            stays where it is, a numpy array goes to the CUDA card).

    """

    def __init__(
        self,
        ref_image=None,
        shape: Optional[tuple] = None,
        fx: Optional[float] = None,
        fy: Optional[float] = None,
        interpolation: Optional[str] = None,
        dtype=None,
        key: str = "",
        device=None,
        **kwargs,
    ) -> None:
        self.device = device
        self.shape = kwargs.get(key + "resize shape") if shape is None else shape
        general_f = kwargs.get(key + "resize")
        self.fx = kwargs.get(key + "resize x", general_f) if fx is None else fx
        self.fy = kwargs.get(key + "resize y", general_f) if fy is None else fy
        self.dtype = kwargs.get(key + "resize dtype") if dtype is None else dtype
        if ref_image is not None:
            if self.shape is not None:
                raise ValueError("Provide only ref_image or shape.")
            self.shape = tuple(ref_image.num_voxels)
        if self.shape is None:
            self.fx = 1 if self.fx is None else self.fx
            self.fy = 1 if self.fy is None else self.fy
        self.interpolation = (
            kwargs.get(key + "resize interpolation")
            if interpolation is None
            else interpolation
        )
        known = (None, "inter_area", "inter_linear", "inter_nearest")
        if self.interpolation not in known:
            raise NotImplementedError(
                f"Interpolation option {self.interpolation} is not implemented."
            )
        self.is_conservative = kwargs.get(key + "resize conservative", False)

    def __str__(self) -> str:
        return "resize"

    def _target_shape(self, current: tuple) -> tuple:
        if self.shape is not None:
            return tuple(self.shape[:2])
        return (
            max(int(round(current[0] * self.fy)), 1),
            max(int(round(current[1] * self.fx)), 1),
        )

    def __call__(self, img, overwrite: bool = False):
        """Resize a tensor or an Image (returning the same kind)."""
        is_image = hasattr(img, "img")
        arr = img.img if is_image else as_tensor(img, self.device)
        if self.dtype is not None:
            arr = convert_dtype(arr, self.dtype)
        resized = resize_array(
            arr,
            self._target_shape(tuple(arr.shape[:2])),
            interpolation=self.interpolation or "inter_area",
            conservative=self.is_conservative,
        )
        if not self.is_conservative and not arr.dtype.is_floating_point:
            resized = torch.round(resized).to(arr.dtype)
        if not is_image:
            return resized
        if overwrite:
            img.img = resized
            return img
        return type(img)(img=resized, **img.metadata())

    def save(self, path) -> None:
        """Persist as npz in the JAX package's format (for ``read_correction``)."""
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {
            "shape": self.shape,
            "fx": self.fx,
            "fy": self.fy,
            "interpolation": self.interpolation,
            "is_conservative": self.is_conservative,
        }
        np.savez(path, class_name="Resize", state=np.array([state], dtype=object))

    def load(self, path) -> None:
        state = load_npz(path)["state"][0]
        self.shape = state["shape"]
        self.fx = state["fx"]
        self.fy = state["fy"]
        self.interpolation = state["interpolation"]
        self.is_conservative = state["is_conservative"]


def resize(image, **kwargs):
    """Functional resize of an Image (kwargs as in :class:`Resize`)."""
    return Resize(**kwargs)(image)


def equalize_voxel_size(image, voxel_size: Optional[float] = None, **kwargs):
    """Resize a 2-D image so all voxels become squares of size ``voxel_size``
    (default: the smaller of the two present sizes); ``interpolation`` in
    ``kwargs`` (default "inter_linear")."""
    if voxel_size is None:
        voxel_size = min(image.voxel_size)
    shape = tuple(int(round(image.dimensions[i] / voxel_size)) for i in range(2))
    interpolation = kwargs.get("interpolation", "inter_linear")
    return Resize(shape=shape, interpolation=interpolation)(image)


def uniform_refinement(image, levels: int):
    """Refine (levels > 0, linear) or coarsen (levels < 0, area) a 2-D image
    by powers of two."""
    factor = 2.0**levels
    shape = tuple(max(int(round(n * factor)), 1) for n in image.num_voxels[:2])
    interpolation = "inter_linear" if levels >= 0 else "inter_area"
    return Resize(shape=shape, interpolation=interpolation)(image)
