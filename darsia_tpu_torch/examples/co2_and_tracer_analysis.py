"""Simple image analysis: CO2 and tracer concentrations.

The port of the JAX package's ``examples/co2_and_tracer_analysis.py``
(synthetic branch; the lab photographs are not in the repository): two
``ConcentrationAnalysis`` pipelines, red-channel CO2 detection and grayscale
tracer detection, each reduction -> TVD -> linear + clip model.  The ranges
are reduced on the tensor (``co2.img.min()``): ``np.min`` of a tensor calls
``Tensor.min(axis=None, out=None)``, which raises.
"""

from __future__ import annotations

import torch

from .. import TVD, ClipModel, CombinedModel, ConcentrationAnalysis, LinearModel, MonochromaticReduction, Resize
from ..image.image import card_unless
from . import Report, cli
from ._data import load_baseline, load_co2_series


def concentration_analysis(base, color: str, tvd_opts: dict) -> ConcentrationAnalysis:
    return ConcentrationAnalysis(
        base=base,
        signal_reduction=MonochromaticReduction(color=color),
        restoration=TVD(**tvd_opts),
        model=CombinedModel([LinearModel(scaling=4.0), ClipModel(**{"min_value": 0.0, "max_value": 1.0})]),
    )


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the CO2 and tracer example")
    report = Report()
    baseline_co2 = baseline_tracer = load_baseline(shape=(180, 340), device=device)
    series = load_co2_series(shape=(180, 340), device=device)
    co2_image, tracer_image = series[2], series[1]
    if fast:
        shrink = Resize(shape=(426, 795))
        baseline_co2 = shrink(baseline_co2)
        baseline_tracer = shrink(baseline_tracer)
        co2_image = shrink(co2_image)
        tracer_image = shrink(tracer_image)
    tvd_opts = {"max_num_iter": 30} if fast else {}

    co2 = concentration_analysis(baseline_co2, "red", tvd_opts)(co2_image)
    co2_range = (float(co2.img.min()), float(co2.img.max()))
    report("co2 concentration range:", *co2_range)

    tracer = concentration_analysis(baseline_tracer, "gray", tvd_opts)(tracer_image)
    tracer_range = (float(tracer.img.min()), float(tracer.img.max()))
    report("tracer concentration range:", *tracer_range)
    if not (bool(torch.isfinite(co2.img).all()) and bool(torch.isfinite(tracer.img).all())):
        raise RuntimeError("non-finite concentration")
    return {"lines": report.lines, "co2_range": co2_range, "tracer_range": tracer_range}


if __name__ == "__main__":
    cli(main)
