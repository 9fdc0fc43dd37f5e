"""Signal models."""

from .basemodel import HeterogeneousModel, Model
from .binarydataselector import (
    BaseCriterion,
    BinaryDataSelector,
    CombinedCriterion,
    GradientModulusCriterion,
    RelativeValueCriterion,
    TransformedValueCriterion,
    ValueCriterion,
)
from .clipmodel import ClipModel
from .color_path_interpolation import (
    ColorPathFunction,
    ColorPathInterpolation,
    LabelColorPathInterpolation,
)
from .combinedmodel import CombinedModel
from .dynamicthresholdmodel import (
    DynamicThresholdModel,
    GlobalMinTwoPeakHistogrammAnalysis,
    HistogrammBasedThresholding,
    OtsuTwoPeakHistogrammAnalysis,
    StandardOtsu,
    TwoPeakHistogrammAnalysis,
    otsu_threshold,
)
from .kernelinterpolation import AdvancedKernelInterpolation, KernelInterpolation
from .linearmodel import HeterogeneousLinearModel, LinearModel, ScalingModel
from .pwtransformation import PWTransformation
from .staticthresholdmodel import StaticThresholdModel
from .thresholdmodel import ThresholdModel

__all__ = [
    "AdvancedKernelInterpolation",
    "KernelInterpolation",
    "BaseCriterion",
    "BinaryDataSelector",
    "ClipModel",
    "ColorPathFunction",
    "ColorPathInterpolation",
    "CombinedCriterion",
    "CombinedModel",
    "DynamicThresholdModel",
    "GlobalMinTwoPeakHistogrammAnalysis",
    "GradientModulusCriterion",
    "HeterogeneousLinearModel",
    "HeterogeneousModel",
    "HistogrammBasedThresholding",
    "LabelColorPathInterpolation",
    "LinearModel",
    "Model",
    "OtsuTwoPeakHistogrammAnalysis",
    "PWTransformation",
    "RelativeValueCriterion",
    "ScalingModel",
    "StandardOtsu",
    "StaticThresholdModel",
    "ThresholdModel",
    "TransformedValueCriterion",
    "TwoPeakHistogrammAnalysis",
    "ValueCriterion",
    "otsu_threshold",
]
