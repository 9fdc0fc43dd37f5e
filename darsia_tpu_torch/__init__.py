"""darsia_tpu_torch: the PyTorch/CUDA port of darsia_tpu.

The JAX package ``darsia_tpu`` is the reference; this package keeps its file
layout and public names, so each module has a counterpart there.  Ported so
far: the per-frame production path (correction chain -> single-scale
registration -> concentration) for single frames, with the two-pass warp as
a hand-written CUDA kernel (``ops/warp2pass.py``, ``csrc/``).  Tensors stay
on the device they are given; nothing here imports JAX.
"""

import torch

# Full f32 matmuls: the registration's TPS evaluation (E @ (Ainv @ v)) and
# later colour-balance matmuls cancel large terms, and TF32's 10-bit mantissa
# would move the displacement field by far more than the parity tolerances.
# PyTorch defaults matmul TF32 off but cuDNN TF32 on; both are set here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .analysis import (  # noqa: E402
    ConcentrationAnalysis,
    FusedAnalysisPipeline,
    ImageRegistration,
    TranslationAnalysis,
)
from .corrections import CurvatureCorrection, TranslationCorrection  # noqa: E402
from .image import Image, OpticalImage, ScalarImage  # noqa: E402
from .restoration import H1_regularization  # noqa: E402
from .signals.models import LinearModel  # noqa: E402
from .signals.reduction import MonochromaticReduction  # noqa: E402
from .utils.linear_solvers import Jacobi  # noqa: E402

__all__ = [
    "ConcentrationAnalysis",
    "CurvatureCorrection",
    "FusedAnalysisPipeline",
    "H1_regularization",
    "Image",
    "ImageRegistration",
    "Jacobi",
    "LinearModel",
    "MonochromaticReduction",
    "OpticalImage",
    "ScalarImage",
    "TranslationAnalysis",
    "TranslationCorrection",
]
