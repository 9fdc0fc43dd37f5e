"""TOML config system for FluidFlower workflows.

Counterpart of :mod:`darsia_tpu.presets.workflows.config`: the same section
classes, warnings, errors and ``check()`` on ``tomllib``, in plain Python
(the colour embeddings they parse are the port's).  A config read on the
card's machine names ``.npz``/``.npy`` images: the port decodes no JPEG.
"""

from .toml_utils import (
    deep_merge,
    read_toml,
    get_section,
    get_key,
    convert_to_hours,
    convert_none,
    validate_choice,
)
from .time_data import (
    TimeInterval,
    TimeWindow,
    TimeData,
    ImageTimeData,
    ImageTimeIntervalData,
    PathData,
)
from .data import DataConfig, DataRegistry
from .rig import RigConfig
from .depth import DepthConfig
from .facies import FaciesConfig
from .labeling import LabelingConfig
from .image_porosity import ImagePorosityConfig
from .protocol import ProtocolConfig
from .corrections import (
    TypeCorrectionConfig,
    ResizeCorrectionConfig,
    CurvatureCorrectionConfig,
    DriftCorrectionConfig,
    ColorCorrectionConfig,
    IlluminationCorrectionConfig,
    PatchwiseIlluminationCorrectionConfig,
    CorrectionsConfig,
)
from .restoration import VolumeAveragingConfig, TVDConfig, RestorationConfig
from .roi import RoiConfig, MultiRoiConfig, RoiAndLabelConfig, RoiAndSubroiConfig
from .roi_registry import RoiRegistry
from .format_registry import (
    ImageExportFormat,
    FormatRegistry,
    SUPPORTED_EXPORT_FORMATS,
)
from .color_embedding_registry import (
    ColorEmbeddingRegistry,
    parse_color_path_embedding,
    parse_color_range_embedding,
    parse_color_channel_embedding,
)
from .contour_smoother import (
    ContourSmootherConfig,
    SavitzkyGolaySmootherConfig,
    make_contour_smoother,
)
from .segmentation import SegmentationValueLabelsConfig, SegmentationConfig
from .fingers import FingersConfig
from .calibration import (
    CalibrationColorConfig,
    CalibrationMassConfig,
    CalibrationConfig,
)
from .analysis import (
    SUPPORTED_ANALYSIS_MASS_EXPORT_MODES,
    AnalysisThresholdingLegendConfig,
    AnalysisThresholdingConfig,
    AnalysisSegmentationConfig,
    AnalysisMassConfig,
    AnalysisVolumeConfig,
    AnalysisExpertKnowledgeConfig,
    AnalysisFingersConfig,
    AnalysisCroppingConfig,
    AnalysisConfig,
)
from .video import (
    VideoSourceConfig,
    VideoOutputConfig,
    VideoOverlayConfig,
    VideoConfig,
)
from .download import DownloadConfig
from .helper import (
    HelperRoiConfig,
    HelperRoiViewerConfig,
    HelperResultsConfig,
    HelperColorConfig,
    HelperConfig,
)
from .color_to_mass import ColorToMassConfig
from .workflow_utils import WorkflowUtilsConfig
from .wasserstein import WassersteinDistancesConfig
from .fluidflower_config import FluidFlowerConfig
from .multi_fluidflower_config import (
    MultiFluidFlowerRunsConfig,
    MultiFluidFlowerDataConfig,
    EventConfig,
    EventsConfig,
    MultiFluidFlowerConfig,
)
