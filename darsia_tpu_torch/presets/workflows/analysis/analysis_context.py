"""Shared analysis context: config, experiment, rig and pipelines.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.analysis_context`.
:func:`prepare_analysis_context` takes the ``device`` the port's other entry
points take (None: the CUDA card): the rig is loaded there, and the
restoration, the colour-to-mass chain and the embeddings compute there.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional
from warnings import warn

from ....experiment.experiment import ProtocolledExperiment
from ....multiphase.mass_analysis import CO2MassAnalysis
from ....signals.color import ColorEmbeddingRuntime, ColorPathEmbedding
from ..config.fluidflower_config import FluidFlowerConfig
from ..config.time_data import TimeData
from ..heterogeneous_color_to_mass_analysis import HeterogeneousColorToMassAnalysis
from ..rig import Rig
from .expert_knowledge import ExpertKnowledgeAdapter

__all__ = [
    "AnalysisContext",
    "select_image_paths",
    "build_restoration",
    "prepare_analysis_context",
    "infer_require_color_to_mass_from_config",
    "iter_prefetched_images",
]


def iter_prefetched_images(ctx, image_paths=None, depth=None):
    """Yield ``(index, path, image_or_None)`` over an analysis image set
    with the reads prefetched on worker threads.

    Up to ``depth`` upcoming ``read_image`` calls (read, decode, the
    correction chain on the rig's device) run ahead on a thread pool while
    the caller analyses the current image (``utils/prefetch.py``; None: the
    host's core count + 1, ``depth <= 0``: sequential).  Read failures are
    logged and yielded as ``None``, so callers keep the loops' best-effort
    semantics.  Indices start at 1, matching the progress events.
    """
    import logging

    from ....utils.prefetch import prefetch_map

    logger = logging.getLogger(__name__)
    paths = [Path(p) for p in (ctx.image_paths if image_paths is None else image_paths)]
    results = prefetch_map(ctx.fluidflower.read_image, paths, depth=depth)
    for index, result in enumerate(results, start=1):
        if not result.ok:
            logger.error(
                "Failed to read image '%s': %s", result.item, result.error
            )
            yield index, Path(result.item), None
        else:
            yield index, Path(result.item), result.value


def infer_require_color_to_mass_from_config(
    path,
    *,
    include_segmentation: bool = False,
    include_fingers: bool = False,
    include_thresholding: bool = False,
    include_mass: bool = False,
    include_volume: bool = False,
) -> bool:
    """Whether the selected analyses need the color-to-mass pipeline:
    mass/volume always do; for the other steps, the decision follows the
    configured modes.  Unknown or absent configuration conservatively
    answers True."""
    from ..mode_resolution import mode_requires_color_to_mass

    if include_mass or include_volume:
        return True
    config = FluidFlowerConfig(path, require_results=True, require_data=True)
    if config.analysis is None:
        return True

    def _collect(step_config) -> list:
        if step_config is None:
            return []
        cfg = getattr(step_config, "config", step_config)
        if isinstance(cfg, dict):
            return [c.mode for c in cfg.values() if getattr(c, "mode", None)]
        mode = getattr(cfg, "mode", None)
        return [mode] if mode else []

    modes: list = []
    if include_segmentation:
        modes.extend(_collect(config.analysis.segmentation))
    if include_fingers:
        modes.extend(_collect(config.analysis.fingers))
    if include_thresholding and config.analysis.thresholding is not None:
        modes.extend(
            layer.mode
            for layer in config.analysis.thresholding.layers.values()
        )
    if not modes:
        return True
    return any(mode_requires_color_to_mass(mode) for mode in modes)


@dataclass
class AnalysisContext:
    """Everything an analysis step needs, initialized once."""

    config: FluidFlowerConfig
    experiment: ProtocolledExperiment
    fluidflower: Rig
    analysis_labels: Any
    image_paths: list
    restoration: Any = None
    color_to_mass_analysis: Optional[HeterogeneousColorToMassAnalysis] = None
    expert_knowledge_adapter: Optional[ExpertKnowledgeAdapter] = None
    color_embedding_runtime: Optional[ColorEmbeddingRuntime] = None


def select_image_paths(
    config,
    experiment,
    all: bool = False,
    sub_config=None,
    source=None,
    data_registry=None,
) -> list:
    """Resolve the image set for an analysis step."""
    assert config.data is not None
    if all or sub_config is None:
        return experiment.find_images_for_paths(paths=config.data.data or [])
    data = getattr(sub_config, "data", None)
    if isinstance(data, (str, list)) and data:
        if data_registry is None:
            raise ValueError(
                "sub_config.data references the registry, but no "
                "data_registry was provided."
            )
        resolved = data_registry.resolve(data)
        if resolved.image_paths:
            return experiment.find_images_for_paths(paths=resolved.image_paths)
        return experiment.find_images_for_times(
            times=resolved.all_times(), data=source
        )
    if isinstance(data, TimeData):
        image_paths = []
        if data.image_paths:
            image_paths += experiment.find_images_for_paths(
                paths=data.image_paths
            )
        times = data.all_times()
        if times:
            found = experiment.find_images_for_times(times=times, data=source)
            image_paths += found if isinstance(found, list) else [found]
        for window in data.image_windows.values():
            image_paths += experiment.find_images_for_time_windows(
                [window], data=source
            )
        if image_paths:
            return sorted(set(image_paths))
    return experiment.find_images_for_paths(paths=config.data.data or [])


def build_restoration(restoration_config, rig: Rig):
    """Instantiate the configured restoration with rig-derived ignore
    masks on the rig's device (delegates to workflows.restoration)."""
    from ..restoration import build_restoration as _build

    if restoration_config is None:
        return None
    try:
        return _build(restoration_config, rig)
    except Exception as e:
        warn(f"Restoration not built: {e}")
        return None


def _build_color_to_mass_analysis(
    config, experiment, rig, restoration, expert_knowledge_adapter
) -> HeterogeneousColorToMassAnalysis:
    """The configured colour-path chain from its calibration folder, on
    the rig's device."""
    assert config.color is not None and config.analysis is not None
    assert config.analysis.mass is not None
    embedding = config.analysis.mass.color
    if isinstance(embedding, str):
        embedding = config.color.resolve(embedding)
    if not isinstance(embedding, ColorPathEmbedding):
        raise NotImplementedError(
            "Mass analysis currently only supports color-path embeddings."
        )
    analysis_labels = embedding.get_labels(rig)
    start = experiment.experiment_start
    if experiment.pressure_temperature_protocol is not None:
        state = experiment.pressure_temperature_protocol.get_state(start)
        gradient = experiment.pressure_temperature_protocol.get_gradient(start)
        pressure, temperature = state.pressure, state.temperature
        dp, dt = gradient.pressure, gradient.temperature
    else:
        pressure, temperature, dp, dt = 1.01, 23.0, 0.0, 0.0
    co2_mass_analysis = CO2MassAnalysis(
        baseline=rig.baseline,
        atmospheric_pressure=pressure,
        atmospheric_temperature=temperature,
        atmospheric_pressure_gradient=dp,
        atmospheric_temperature_gradient=dt,
    )
    return HeterogeneousColorToMassAnalysis.from_folder(
        folder=embedding.color_to_mass_folder,
        baseline=rig.baseline,
        labels=analysis_labels,
        co2_mass_analysis=co2_mass_analysis,
        geometry=rig.geometry,
        restoration=restoration,
        basis=embedding.basis,
        expert_knowledge_adapter=expert_knowledge_adapter,
        contour_smoother=config.analysis.mass.contour_smoother,
        color_mode=embedding.mode,
    )


def prepare_analysis_context(
    cls=Rig,
    path=None,
    all: bool = False,
    require_color_to_mass: bool = False,
    section: Optional[str] = "analysis",
    require_results: bool = True,
    require_data: bool = True,
    sub_config: Any = None,
    device=None,
) -> AnalysisContext:
    """Initialize all shared analysis objects from TOML config path(s) on
    ``device`` (None: the CUDA card)."""
    config = FluidFlowerConfig(
        path, require_results=require_results, require_data=require_data
    )
    if section in {"analysis", "calibration"}:
        config.check(section, "protocol", "data", "rig")
    else:
        config.check("protocol", "data", "rig")
    assert config.rig is not None and config.data is not None

    experiment = ProtocolledExperiment.init_from_config(config)
    fluidflower = cls.load(config.rig.path, config.corrections, device=device)
    fluidflower.load_experiment(experiment)

    if sub_config is None:
        sub_config = getattr(config, section, None) if section else None

    image_paths = select_image_paths(
        config,
        experiment,
        all=all,
        sub_config=sub_config,
        data_registry=config.data.registry,
    )
    restoration = build_restoration(config.restoration, fluidflower)
    expert_knowledge_adapter = ExpertKnowledgeAdapter.from_config(
        config=(
            config.analysis.expert_knowledge
            if config.analysis is not None
            else None
        ),
        roi_registry=config.roi_registry,
    )
    color_embedding_runtime = ColorEmbeddingRuntime(rig=fluidflower, device=fluidflower.device)
    if require_color_to_mass:
        color_to_mass_analysis = _build_color_to_mass_analysis(
            config=config,
            experiment=experiment,
            rig=fluidflower,
            restoration=restoration,
            expert_knowledge_adapter=expert_knowledge_adapter,
        )
        embedding = config.analysis.mass.color
        if isinstance(embedding, str):
            embedding = config.color.resolve(embedding)
        analysis_labels = embedding.get_labels(fluidflower)
    else:
        color_to_mass_analysis = None
        analysis_labels = None

    return AnalysisContext(
        config=config,
        experiment=experiment,
        fluidflower=fluidflower,
        analysis_labels=analysis_labels,
        image_paths=image_paths,
        restoration=restoration,
        color_to_mass_analysis=color_to_mass_analysis,
        expert_knowledge_adapter=expert_knowledge_adapter,
        color_embedding_runtime=color_embedding_runtime,
    )
