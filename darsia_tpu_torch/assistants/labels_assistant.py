"""Label-map editing assistants: segment, select, pick, merge.

Counterpart of :mod:`darsia_tpu.assistants.labels_assistant`.  The JAX
package's menu-driven loop is a set of methods here, each usable headless
with explicit inputs.  The label map stays on its device: the masks, picks,
merges and renumbering are tensor operations there; only the watershed of
:func:`darsia_tpu_torch.utils.segmentation.segment` runs on a host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.image import Image, as_tensor
from ..utils.segmentation import segment
from .base_assistant import BaseAssistant

__all__ = [
    "LabelsSegmentAssistant",
    "LabelsMaskSelectionAssistant",
    "LabelsPickAssistant",
    "LabelsMergeAssistant",
    "LabelsAssistant",
    "LabelsAssistantMenu",
    "MonochromaticAssistant",
]


def _labels_image(template, data: torch.Tensor) -> Image:
    meta = template.metadata()
    meta["scalar"] = True
    meta.pop("color_space", None)
    return Image(data.to(torch.int32), **meta)


def _consecutive(labels: torch.Tensor) -> torch.Tensor:
    """The labels renumbered 0, 1, ... in the order of their values."""
    _, inverse = torch.unique(labels, return_inverse=True)
    return inverse.reshape(labels.shape)


def _ids_at(labels: torch.Tensor, points) -> list:
    """The label under each (row, col) point, read in one copy."""
    pts = np.asarray(points, dtype=float).astype(int).reshape(-1, 2)
    rows = torch.as_tensor(pts[:, 0], device=labels.device)
    cols = torch.as_tensor(pts[:, 1], device=labels.device)
    return [int(v) for v in labels[rows, cols].cpu().tolist()]


class LabelsSegmentAssistant:
    """(Re-)segment a region of the background image by watershed."""

    def __init__(self, labels, background, mask=None, **kwargs) -> None:
        self.labels = labels
        self.background = background
        self.mask = None if mask is None else as_tensor(mask, background.img.device).to(torch.bool)
        self.kwargs = kwargs

    def __call__(self, marker_points=None) -> Image:
        kwargs = {k: v for k, v in self.kwargs.items() if k != "marker_points"}
        device = self.background.img.device
        new_labels = segment(
            self.background,
            markers_method="supervised" if marker_points else "gradient_based",
            edges_method="scharr",
            mask=None if self.mask is None else self.mask.cpu().numpy(),
            marker_points=marker_points,
            device=device,
            **kwargs,
        )
        new = as_tensor(new_labels.img if hasattr(new_labels, "img") else new_labels, device)
        if self.labels is None or self.mask is None:
            return _labels_image(self.background, new)
        # Splice the new segmentation into the existing labels.
        old = self.labels.img.to(torch.int64)
        spliced = torch.where(self.mask.to(old.device), new.to(old) + old.max() + 1, old)
        return _labels_image(self.labels, _consecutive(spliced))


class LabelsMaskSelectionAssistant:
    """Pick labels (by point or id) and return their union as a mask."""

    def __init__(self, labels, background=None, **kwargs) -> None:
        self.labels = labels
        self.background = background
        self.kwargs = kwargs

    def __call__(self, points=None, ids=None) -> torch.Tensor:
        labels = self.labels.img
        if ids is None:
            assert points is not None, (
                "Provide points or ids (interactive picking unavailable headless)."
            )
            ids = _ids_at(labels, points)
        return torch.isin(labels, torch.as_tensor(list(ids), device=labels.device).to(labels.dtype))


class LabelsPickAssistant:
    """The labels of the picked regions, 0 elsewhere."""

    def __init__(self, labels, background=None, **kwargs) -> None:
        self.labels = labels
        self.background = background
        self.kwargs = kwargs

    def __call__(self, points=None, ids=None) -> Image:
        mask = LabelsMaskSelectionAssistant(self.labels, self.background)(points=points, ids=ids)
        out = self.labels.copy()
        out.img = torch.where(mask, out.img, torch.zeros_like(out.img))
        return out


class LabelsMergeAssistant:
    """Merge a set of labels into one (the smallest id), then renumber."""

    def __init__(self, labels, background=None, **kwargs) -> None:
        self.labels = labels
        self.background = background

    def __call__(self, points=None, ids=None) -> Image:
        labels = self.labels.img
        if ids is None:
            assert points is not None, "Provide points or ids."
            ids = _ids_at(labels, points)
        merged = torch.isin(labels, torch.as_tensor(list(ids), device=labels.device).to(labels.dtype))
        labels = torch.where(merged, torch.full_like(labels, min(ids)), labels)
        return _labels_image(self.labels, _consecutive(labels))


class LabelsAssistant:
    """The label-editing modules behind one object; the JAX package's menu
    becomes its methods."""

    def __init__(self, labels=None, background=None, **kwargs) -> None:
        self.labels = labels
        self.background = background
        self.kwargs = kwargs

    def segment(self, mask=None, marker_points=None) -> Image:
        self.labels = LabelsSegmentAssistant(
            self.labels, self.background, mask=mask, **self.kwargs
        )(marker_points=marker_points)
        return self.labels

    def refine(self, ids=None, points=None, marker_points=None) -> Image:
        mask = LabelsMaskSelectionAssistant(self.labels, self.background)(points=points, ids=ids)
        self.labels = LabelsSegmentAssistant(
            self.labels, self.background, mask=mask, **self.kwargs
        )(marker_points=marker_points)
        return self.labels

    def pick(self, ids=None, points=None) -> Image:
        return LabelsPickAssistant(self.labels, self.background)(points=points, ids=ids)

    def merge(self, ids=None, points=None) -> Image:
        self.labels = LabelsMergeAssistant(self.labels, self.background)(points=points, ids=ids)
        return self.labels

    def __call__(self) -> Image:
        if self.labels is None:
            return self.segment()
        return self.labels


class LabelsAssistantMenu(BaseAssistant):
    """The interactive key-press menu of the label assistant; headless
    callers use the methods of :class:`LabelsAssistant`."""

    _ACTIONS = {
        "s": "segment",
        "r": "refine",
        "p": "pick",
        "m": "merge",
        "e": "escape",
    }

    def __init__(self, img, background=None, **kwargs) -> None:
        super().__init__(img, **kwargs)
        self.background = background
        self.action = None

    def _print_instructions(self) -> None:
        print("LabelsAssistant menu: s=segment r=refine p=pick m=merge e=exit")

    def _on_key_press(self, event) -> None:
        if event.key in self._ACTIONS:
            self.action = self._ACTIONS[event.key]
            self._finalize()

    def __call__(self) -> str:
        self.action = None
        super().__call__()
        return self.action


class MonochromaticAssistant:
    """A monochromatic view of a colour image; headless callers pass
    ``color``."""

    def __init__(self, img, color: str = "gray", **kwargs) -> None:
        self.img = img
        self.color = color

    def __call__(self):
        from ..signals.reduction.signalreduction import MonochromaticReduction

        out = self.img.copy()
        out.img = MonochromaticReduction(color=self.color)(self.img.img)
        return out
