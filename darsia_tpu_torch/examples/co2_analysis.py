"""CO2 phase segmentation with the FluidFlower benchmark preset.

The port of the JAX package's ``examples/co2_analysis.py``: the baseline and
three CO2 frames are saved as ``.npz`` files, and ``FluidFlowerCO2Analysis``
reads each through its corrections and segments dissolved CO2 and CO2(g).
Where matplotlib does not import, the contour plots raise naming it; the
frame is then analysed without them and the message is returned under
``"missing"``.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch

from .. import FluidFlowerCO2Analysis
from ..image.image import card_unless
from . import Report, cli, missing_library
from ._data import load_baseline, load_co2_series

# The configuration both CO2 examples share (each phase adds its colour,
# threshold and cleaning filter).
COMMON = {
    "diff option": "absolute",
    "restoration -> model": True,
    "restoration resize": 0.5,
    "restoration method": "chambolle",
    "restoration weight": 0.02,
    "restoration max_num_iter": 50,
    "prior remove small objects size": 20,
    "prior fill holes size": 20,
    "prior resize": 0.5,
    "prior method": "chambolle",
    "prior weight": 0.02,
    "prior max_num_iter": 50,
    "posterior criterion": "value",
    "posterior threshold": 0.02,
}


def phase_sections(work: Path) -> dict:
    """The ``co2`` and ``co2(g)`` sections, their cleaning filters in ``work``."""
    return {
        "co2": dict(
            COMMON,
            **{
                "color": "negative-key",
                "prior threshold value": 0.12,
                "cleaning_filter": str(work / "cache" / "c1.npy"),
            },
        ),
        "co2(g)": dict(
            COMMON,
            **{
                "color": "blue",
                "prior threshold value": 0.12,
                "cleaning_filter": str(work / "cache" / "c2.npy"),
            },
        ),
    }


def save_frames(work: Path, device) -> list:
    """The baseline and the three CO2 frames (180x340) as ``.npz`` files in
    ``work``; the frames' paths."""
    load_baseline(shape=(180, 340), device=device).save(work / "baseline.npz")
    paths = []
    for i, img in enumerate(load_co2_series(shape=(180, 340), device=device)):
        img.save(work / f"co2_{i}.npz")
        paths.append(work / f"co2_{i}.npz")
    return paths


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the CO2 analysis example")
    report = Report()
    work = Path(tempfile.mkdtemp(prefix="co2_example_"))
    paths = save_frames(work, device)
    config = {"physical_asset": {"dimensions": {"width": 2.8, "height": 1.5}}, **phase_sections(work)}
    config_path = work / "config.json"
    config_path.write_text(json.dumps(config))

    analysis = FluidFlowerCO2Analysis(
        baseline=work / "baseline.npz", config=config_path, results=work / "results", device=device
    )
    missing, fractions = [], []
    for i, path in enumerate(paths):
        try:
            co2, co2_gas = analysis.single_image_analysis(path, write_contours_to_file=True)
        except ImportError as err:
            missing.append(missing_library(err, "matplotlib"))
            co2, co2_gas = analysis.single_image_analysis(path)
        c, g = co2.img.to(torch.bool), co2_gas.img.to(torch.bool)
        share_c, share_g = float(c.double().mean()), float(g.double().mean())
        fractions.append((share_c, share_g))
        report(
            f"co2_{i}: co2 {share_c:.3f} of domain, gas {share_g:.3f}, "
            f"gas within co2: {bool((~c & g).sum() == 0)}"
        )
    report("contour plots in", work / "results" / "contour_plots")
    return {"lines": report.lines, "fractions": fractions, "missing": missing}


if __name__ == "__main__":
    cli(main)
