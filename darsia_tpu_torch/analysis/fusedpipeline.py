"""The per-frame production path: correct -> register -> concentrate.

Counterpart of :mod:`darsia_tpu.analysis.fusedpipeline` for the default
(two-warp, single-frame) lane.  The pipeline is built from the public
objects (correction instances, :class:`ImageRegistration`,
:class:`ConcentrationAnalysis`); :meth:`FusedAnalysisPipeline._build` turns
them into a ``frame(data, operands)`` function plus its setup products (the
correction field, the registration operands, the baseline), and each call
runs that function eagerly.  On CUDA tensors the frame launches the
two-pass warp kernel four times: two passes for the correction warp and two
for the registration warp.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..corrections.fuse import _collect_group, fused_chain
from ..image.image import Image, ScalarImage
from ..utils.dtype import convert_dtype

__all__ = ["FusedAnalysisPipeline"]


def _resolve_translation_analysis(registration):
    """TranslationAnalysis behind any public registration facade."""
    if registration is None:
        return None
    engine = getattr(registration, "_engine", registration)
    return getattr(engine, "translation_analysis", engine)


class FusedAnalysisPipeline:
    """correct + register + concentrate for single frames.

    Args:
        transformations: the correction chain (as ``Image(transformations=)``
            takes it); maximal runs of fusable geometric corrections run as
            one warp, any other correction through its ``correct_array``.
        registration: optional single-scale :class:`ImageRegistration`.
        analysis: optional :class:`ConcentrationAnalysis`.
        max_disp: displacement bound of the registration warp.
        single_warp: not ported yet; must be False.

    """

    def __init__(
        self,
        transformations: Optional[Sequence] = None,
        registration=None,
        analysis=None,
        max_disp: int = 120,
        single_warp: bool = False,
    ) -> None:
        if single_warp:
            raise NotImplementedError("the single-warp lane is not ported yet")
        self.transformations = [
            t for t in (transformations or []) if t is not None and callable(t)
        ]
        self.registration = registration
        self.analysis = analysis
        self.max_disp = int(max_disp)
        self._translation_analysis = _resolve_translation_analysis(registration)
        if registration is not None and self._translation_analysis is None:
            raise ValueError("registration exposes no TranslationAnalysis")
        self._cache: dict = {}

    # ------------------------------------------------------------- building

    def _stage_plan(self, input_shape: tuple, device) -> tuple:
        """``(stages, out_meta)``: ("chain", chain) runs and ("op", corr) steps."""
        chain = self.transformations
        stages, meta = [], {}
        shape = tuple(int(s) for s in input_shape)
        i = 0
        while i < len(chain):
            j = _collect_group(chain, i)
            if j - i >= 2 or (j - i == 1 and hasattr(chain[i], "pullback_field")):
                fused = fused_chain(chain[i:j], shape, device)
                stages.append(("chain", fused))
                shape = tuple(fused.out_shape)
                meta.update(fused.correct_metadata())
                i = j
            else:
                stages.append(("op", chain[i]))
                meta.update(chain[i].correct_metadata(meta) or {})
                i += 1
        return stages, meta

    def _build(self, input_shape: tuple, input_dtype: torch.dtype, device):
        """``(frame, operands)`` for one input signature.

        ``frame(data, ops, warp_impl="auto") -> (concentration, shifts,
        quality)``; ``operands`` is the nested dict of setup tensors
        (``field_k``, ``reg``, ``base``) that :mod:`darsia_tpu_torch.convert`
        can also build from the JAX package's operands.
        """
        stages, _ = self._stage_plan(input_shape, device)
        operands: dict = {}
        for k, (kind, obj) in enumerate(stages):
            if kind == "chain":
                operands[f"field_{k}"] = obj.field

        aligner = None
        if self._translation_analysis is not None:
            aligner, operands["reg"] = self._translation_analysis.fused_aligner_parts(
                max_disp=self.max_disp
            )

        analysis_fn = None
        has_base = False
        if self.analysis is not None:
            analysis_fn = self.analysis.pipeline_fn()
            has_base = self.analysis.base is not None
            if has_base:
                operands["base"] = self.analysis.base.img.to(torch.float32)

        stage_fns = [
            (kind, obj, obj.apply_fn(input_dtype) if kind == "chain" else None)
            for kind, obj in stages
        ]

        def frame(data, ops, warp_impl="auto"):
            x = data
            for k, (kind, obj, chain_apply) in enumerate(stage_fns):
                if kind == "chain":
                    x = chain_apply(x, ops[f"field_{k}"], warp_impl)
                else:
                    x = obj.correct_array(x)
            # Integer frames map to [0, 1] after the correction warp.
            x = convert_dtype(x, torch.float32)
            shifts = quality = None
            if aligner is not None:
                x, shifts, quality = aligner(x, ops["reg"], warp_impl)
            if analysis_fn is not None:
                x = analysis_fn(x, ops["base"]) if has_base else analysis_fn(x)
            return x, shifts, quality

        return frame, operands

    # -------------------------------------------------------------- calling

    def _signature(self, arr: torch.Tensor) -> tuple:
        versions = tuple(
            (id(t), getattr(t, "_fusion_version", 0)) for t in self.transformations
        )
        ta = self._translation_analysis
        reg_fp = (
            None
            if ta is None
            else (id(ta.base.img), tuple(ta.N_patches), ta.rel_overlap, ta.quality_tol)
        )
        analysis_fp = (
            None if self.analysis is None else self.analysis._pipeline_fingerprint()
        )
        return (tuple(arr.shape), arr.dtype, arr.device, versions, analysis_fp, reg_fp)

    def __call__(
        self, image, operands: Optional[dict] = None, warp_impl: str = "auto"
    ) -> Image:
        """Concentration image of one frame.

        Args:
            image: :class:`Image`, (H, W, C) tensor on the device to run on,
                or numpy array (runs on the CPU).
            operands: setup products to use in place of the pipeline's own
                (same structure as :meth:`_build` returns, e.g. from
                :func:`darsia_tpu_torch.convert.operands_from_numpy`).
            warp_impl: "plain" routes the two-pass warp through the plain
                K1 version; for checks only.

        """
        is_image = isinstance(image, Image)
        arr = image.img if is_image else image
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if (is_image and image.series) or arr.dim() == 4:
            raise NotImplementedError("time series are not ported yet")
        key = self._signature(arr)
        entry = self._cache.get(key)
        if entry is None:
            if len(self._cache) >= 4:
                self._cache.pop(next(iter(self._cache)))
            entry = self._cache[key] = self._build(
                tuple(arr.shape[:2]), arr.dtype, arr.device
            )
        frame, own_operands = entry
        conc, shifts, quality = frame(
            arr, own_operands if operands is None else operands, warp_impl
        )
        ta = self._translation_analysis
        if ta is not None:
            ta._stage_shifts(shifts, quality, ta._window_geometry()[1])
        return self._package(conc, image)

    def _package(self, concentration: torch.Tensor, image) -> Image:
        meta = self._output_metadata(image)
        if concentration.dim() == 2:
            return ScalarImage(concentration, **meta)
        return (type(image) if isinstance(image, Image) else Image)(concentration, **meta)

    def _output_metadata(self, image) -> dict:
        """Corrected-space metadata: the baseline's when there is one."""
        if self.analysis is not None and self.analysis.base is not None:
            meta = self.analysis.base.metadata()
        elif self._translation_analysis is not None:
            meta = self._translation_analysis.base.metadata()
        elif isinstance(image, Image):
            meta = image.metadata()
            meta.update(self._stage_plan(tuple(image.shape[:2]), image.device)[1])
        else:
            raise ValueError(
                "Raw-array input needs a baseline-bearing analysis or "
                "registration to supply output metadata."
            )
        meta.pop("series", None)
        return meta
