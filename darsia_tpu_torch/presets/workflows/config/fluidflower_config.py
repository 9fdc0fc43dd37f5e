"""FluidFlowerConfig: the aggregated TOML configuration.

Parity: reference
``presets/workflows/config/fluidflower_config.py:35-346``.  Sections are
loaded best-effort: a missing section warns and leaves the attribute None,
so downstream steps can check availability with ``config.check(...)``.
"""

from __future__ import annotations

from pathlib import Path
from warnings import warn

from .analysis import AnalysisConfig
from .calibration import CalibrationConfig
from .color_embedding_registry import ColorEmbeddingRegistry
from .corrections import CorrectionsConfig
from .data import DataConfig
from .depth import DepthConfig
from .download import DownloadConfig
from .facies import FaciesConfig
from .format_registry import FormatRegistry
from .helper import HelperConfig
from .image_porosity import ImagePorosityConfig
from .labeling import LabelingConfig
from .protocol import ProtocolConfig
from .restoration import RestorationConfig
from .rig import RigConfig
from .roi_registry import RoiRegistry
from .segmentation import SegmentationConfig  # noqa: F401 (re-export)
from .video import VideoConfig
from .workflow_utils import WorkflowUtilsConfig

__all__ = ["FluidFlowerConfig"]


class FluidFlowerConfig:
    """Aggregated configuration for a FluidFlower run."""

    def __init__(
        self,
        path,
        require_data: bool = False,
        require_results: bool = False,
    ) -> None:
        path = (
            [Path(p) for p in path] if isinstance(path, list) else Path(path)
        )
        self.path = path
        results = None
        data_folder = None

        def _try(name: str, loader, *, hint: str, catch=(KeyError,)):
            try:
                setattr(self, name, loader())
            except catch:
                setattr(self, name, None)
                warn(f"Section {name} not found in {path}, use [{hint}].")

        _try(
            "data",
            lambda: DataConfig().load(
                path, require_data=require_data, require_results=require_results
            ),
            hint="data",
        )
        if self.data is not None:
            results = self.data.results
            data_folder = self.data.folder

        _try("rig", lambda: RigConfig().load(path, results=results), hint="rig")
        _try("corrections", lambda: CorrectionsConfig().load(path), hint="corrections")
        _try("restoration", lambda: RestorationConfig().load(path), hint="restoration")
        _try(
            "labeling",
            lambda: LabelingConfig().load(path, results=results),
            hint="labeling",
        )
        _try(
            "facies",
            lambda: FaciesConfig().load(path, results=results),
            hint="facies",
        )
        _try(
            "depth",
            lambda: DepthConfig().load(path, results=results),
            hint="depth",
        )
        _try("image_porosity", lambda: ImagePorosityConfig().load(path),
             hint="image_porosity")
        _try("protocol", lambda: ProtocolConfig().load(path), hint="protocol")
        _try("roi_registry", lambda: RoiRegistry().load(path), hint="roi")

        data_registry = self.data.registry if self.data else None
        _try(
            "color",
            lambda: ColorEmbeddingRegistry().load(
                path,
                data=data_folder,
                results=results,
                data_registry=data_registry,
                roi_registry=self.roi_registry,
            ),
            hint="color",
            catch=(KeyError, ValueError, NotImplementedError),
        )
        _try(
            "calibration",
            lambda: CalibrationConfig().load(
                path,
                color_embedding_registry=self.color,
                data_registry=data_registry,
            ),
            hint="calibration",
            catch=(KeyError, ValueError),
        )
        _try("format_registry", lambda: FormatRegistry().load(path), hint="format")
        _try(
            "analysis",
            lambda: AnalysisConfig().load(
                path,
                data=data_folder,
                results=results,
                data_registry=data_registry,
                roi_registry=self.roi_registry,
                format_registry=self.format_registry,
                color_embedding_registry=self.color,
            ),
            hint="analysis",
        )
        _try(
            "helper",
            lambda: HelperConfig().load(path, data_registry=data_registry),
            hint="helper",
        )
        _try("download", lambda: DownloadConfig().load(path), hint="download")
        _try("workflow_utils", lambda: WorkflowUtilsConfig().load(path), hint="utils")
        _try(
            "video",
            lambda: VideoConfig().load(path, results=results),
            hint="video",
        )

    def load_meta(self, meta) -> dict:
        """Load auxiliary metadata from a JSON or TOML file
        (reference fluidflower_config.py:337-346)."""
        from pathlib import Path as _Path

        meta = _Path(meta)
        if meta.suffix == ".json":
            import json

            return json.loads(meta.read_text())
        if meta.suffix == ".toml":
            import tomllib

            return tomllib.loads(meta.read_text())
        raise ValueError(f"Unsupported meta file format: {meta.suffix}")

    def check(self, *sections: str) -> None:
        """Assert that the given sections were present in the TOML config."""
        missing = [s for s in sections if getattr(self, s, None) is None]
        if missing:
            raise ValueError(
                f"Config {self.path} is missing required sections: {missing}."
            )
