"""Watershed segmentation of a layered medium.

The port of the JAX package's ``examples/segmentation.py``: supervised
markers, Scharr edges, then the label utilities.
"""

from __future__ import annotations

import torch

from .. import group_labels, segment
from ..image.image import card_unless
from . import Report, cli
from ._data import load_baseline


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the segmentation example")
    report = Report()
    image = load_baseline(shape=(135, 256), device=device)
    labels = segment(
        image,
        markers_method="supervised",
        edges_method="scharr",
        marker_points=[[30, 128], [100, 128]],
        device=device,
    )
    found = torch.unique(labels.img).tolist()
    report("labels:", found)

    # Label utilities.
    merged = group_labels(labels, [tuple(found[:2])])
    report("after merge:", torch.unique(merged.img).tolist())
    return {"lines": report.lines, "labels": found}


if __name__ == "__main__":
    cli(main)
