"""Colour-to-mass calibration step.

Counterpart of
:mod:`darsia_tpu.presets.workflows.calibration.calibration_color_to_mass_analysis`:
the chain built from the calibrated colour paths with identity signal
functions and a flash at the configured threshold, on the rig's device;
with ``mode = "auto"`` fitted to the injection protocol
(``HeterogeneousColorToMassAnalysis.automatic_calibration``); saved with its
metadata.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace

import numpy as np

from ....multiphase.flash import SimpleFlash
from ....multiphase.mass_analysis import CO2MassAnalysis
from ....signals.color import ColorPathEmbedding, LabelColorPathMap
from ....signals.models.color_path_interpolation import ColorPathInterpolation
from ....signals.models.pwtransformation import PWTransformation
from ..analysis.analysis_context import (
    AnalysisContext,
    prepare_analysis_context,
    select_image_paths,
)
from ..heterogeneous_color_to_mass_analysis import HeterogeneousColorToMassAnalysis
from .calibration_color_paths import _read_images
from .metadata import validate_basis_metadata, write_calibration_metadata

logger = logging.getLogger(__name__)

__all__ = [
    "calibration_color_to_mass_analysis_from_context",
    "calibration_color_to_mass_analysis",
]


def calibration_color_to_mass_analysis_from_context(
    ctx: AnalysisContext,
    show: bool = False,
    mode: str = "auto",
    maxiter: int = 20,
) -> HeterogeneousColorToMassAnalysis:
    config = ctx.config
    fluidflower = ctx.fluidflower
    experiment = ctx.experiment
    config.check("rig", "data", "protocol", "color", "calibration")
    assert config.calibration is not None and config.calibration.mass is not None
    embedding = config.calibration.mass.color
    if not isinstance(embedding, ColorPathEmbedding):
        raise NotImplementedError("calibration.mass currently supports only color path embeddings.")
    validate_basis_metadata(embedding.color_paths_folder, embedding.basis)

    labels = embedding.get_labels(fluidflower)
    color_paths = LabelColorPathMap.load(embedding.color_paths_folder)
    if not color_paths:
        raise FileNotFoundError(
            f"No calibrated color paths under {embedding.color_paths_folder}; "
            "run the color-path calibration first."
        )
    interpretations = {
        label: ColorPathInterpolation(path, embedding.mode) for label, path in color_paths.items()
    }
    signal_functions = {
        label: PWTransformation(supports=np.linspace(0, 1, 3), values=np.linspace(0, 1, 3))
        for label in color_paths
    }
    threshold = config.calibration.mass.threshold
    flash = SimpleFlash(min_value_aq=0.0, max_value_aq=threshold, min_value_g=threshold, max_value_g=1.0)
    start = experiment.experiment_start
    if experiment.pressure_temperature_protocol is not None:
        state = experiment.pressure_temperature_protocol.get_state(start)
        pressure, temperature = state.pressure, state.temperature
    else:
        pressure, temperature = 1.01, 23.0
    co2_mass_analysis = CO2MassAnalysis(
        baseline=fluidflower.baseline,
        atmospheric_pressure=pressure,
        atmospheric_temperature=temperature,
    )
    chain = HeterogeneousColorToMassAnalysis(
        baseline=fluidflower.baseline,
        labels=labels,
        color_mode=embedding.mode,
        color_path_interpretation=interpretations,
        signal_functions=signal_functions,
        flash=flash,
        co2_mass_analysis=co2_mass_analysis,
        geometry=fluidflower.geometry,
        restoration=ctx.restoration,
        basis=embedding.basis,
        ignore_labels=embedding.ignore_labels,
    )

    if (config.calibration.mass.mode or mode) == "auto":
        images = _read_images(fluidflower, ctx.image_paths)
        chain.automatic_calibration(
            images, experiment, maxiter=getattr(config.calibration.mass, "maxiter", maxiter)
        )

    chain.save(embedding.color_to_mass_folder)
    write_calibration_metadata(
        embedding.color_to_mass_folder,
        embedding.basis,
        extra={"embedding_id": embedding.embedding_id},
    )
    logger.info("Color-to-mass calibration saved to %s.", embedding.color_to_mass_folder)
    return chain


def calibration_color_to_mass_analysis(path, cls=None, device=None, **kwargs):
    """The colour-to-mass calibration of a TOML config on ``device`` (None:
    the CUDA card); the photographs are ``[calibration.mass] data`` where
    given."""
    from ..rig import Rig

    ctx = prepare_analysis_context(
        cls=cls or Rig, path=path, section="calibration", sub_config=None, device=device
    )
    mass = ctx.config.calibration.mass if ctx.config.calibration is not None else None
    if mass is not None and mass.data is not None:
        ctx.image_paths = select_image_paths(
            ctx.config, ctx.experiment, sub_config=SimpleNamespace(data=mass.data)
        )
    return calibration_color_to_mass_analysis_from_context(ctx, **kwargs)
