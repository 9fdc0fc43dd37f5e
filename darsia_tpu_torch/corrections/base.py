"""Correction protocol: array transforms plus metadata bookkeeping.

Counterpart of :mod:`darsia_tpu.corrections.base`.  A time series is
corrected frame by frame (:meth:`BaseCorrection.correct_series_array`).
Corrections persist as npz files in the JAX package's format (class name
plus state), so :func:`read_correction` loads what either package saved.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..utils.npz import load_npz

__all__ = ["BaseCorrection", "TypeCorrection", "read_correction"]


class BaseCorrection:
    """Base correction: an array transform applied to an Image or a tensor."""

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        """Transform a single space(+range) tensor. Override."""
        raise NotImplementedError

    def correct_metadata(self, metadata: Optional[dict] = None) -> dict:
        """Metadata updates induced by the correction. Override if needed."""
        return {}

    def correct_series_array(self, img: torch.Tensor, time_axis: int) -> torch.Tensor:
        """Correct every frame of a series (time on ``time_axis``)."""
        frames = [self.correct_array(frame) for frame in img.unbind(time_axis)]
        return torch.stack(frames, dim=time_axis)

    def __call__(self, image, overwrite: bool = False):
        """Apply the correction to an Image (or a raw tensor).

        Args:
            image: Image or tensor.
            overwrite: update the image in place (the constructor's
                transformation chain); otherwise return a corrected copy.

        """
        if isinstance(image, torch.Tensor):
            return self.correct_array(image)
        if image.series:
            corrected = self.correct_series_array(image.img, image.space_dim)
        else:
            corrected = self.correct_array(image.img)
        meta_update = self.correct_metadata(image.metadata())
        if overwrite:
            image.img = corrected
            for key, value in meta_update.items():
                setattr(image, key, value)
            return image
        metadata = image.metadata()
        metadata.update(meta_update)
        return type(image)(img=corrected, **metadata)

    # ------------------------------------------------------------------- I/O

    def save(self, path: Union[str, Path]) -> None:
        """Persist the correction's state as npz (class-name dispatched)."""
        path = Path(path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            class_name=type(self).__name__,
            state=np.array([self._state_dict()], dtype=object),
        )

    def load(self, path: Union[str, Path]) -> None:
        """Restore the state from npz."""
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"File {path} not found.")
        self._load_state_dict(load_npz(path)["state"][0])

    def _state_dict(self) -> dict:
        """Serializable parameter state (tensors as numpy). Override with load."""
        return {
            k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in self.__dict__.items()
            if not k.startswith("_") and _is_serializable(v)
        }

    def _load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


def _is_serializable(v) -> bool:
    return isinstance(
        v, (int, float, str, bool, list, tuple, dict, np.ndarray, torch.Tensor, type(None))
    )


def _numpy_dtype(data_type) -> np.dtype:
    """A numpy dtype from a numpy or torch dtype (or a name)."""
    if isinstance(data_type, torch.dtype):
        return np.dtype(str(data_type).removeprefix("torch."))
    return np.dtype(data_type)


class TypeCorrection(BaseCorrection):
    """Cast image data to a dtype (with value-range rescaling)."""

    def __init__(self, data_type=None, **kwargs):
        self.data_type = None if data_type is None else _numpy_dtype(data_type)

    def correct_array(self, img: torch.Tensor) -> torch.Tensor:
        from ..utils.dtype import convert_dtype

        return convert_dtype(img, self.data_type)

    def _state_dict(self):
        return {"data_type": str(self.data_type)}

    def _load_state_dict(self, state):
        self.data_type = np.dtype(state["data_type"])


def read_correction(path: Union[str, Path]):
    """The correction saved in an npz file (by this package or the JAX
    package), dispatched on its class name."""
    from . import CORRECTION_REGISTRY

    path = Path(path)
    class_name = str(load_npz(path, names=("class_name",))["class_name"])
    if class_name not in CORRECTION_REGISTRY:
        raise ValueError(f"Unknown correction class {class_name}.")
    cls = CORRECTION_REGISTRY[class_name]
    correction = cls.__new__(cls)
    # Default attributes first, as the JAX package does; classes that need
    # constructor arguments are left to load().
    try:
        correction.__init__()
    except TypeError:
        pass
    correction.load(path)
    return correction
