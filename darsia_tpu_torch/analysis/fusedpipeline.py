"""The per-frame production path: correct -> register -> concentrate.

Counterpart of :mod:`darsia_tpu.analysis.fusedpipeline`.  The pipeline is
built from the public objects (correction instances,
:class:`ImageRegistration`, :class:`ConcentrationAnalysis`);
:meth:`FusedAnalysisPipeline._build` turns them into a ``frame(data,
operands)`` function plus its setup products (the correction field, the
registration operands, the baseline), and each call runs that function
eagerly, once per frame of a time series.  On CUDA tensors a frame launches
the two-pass warp kernel four times: two passes for the correction warp and
two for the registration warp, or, in the single-warp lane, two for the
1-channel gray warp and two for the one colour warp.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..corrections.fuse import _collect_group, fused_chain
from ..image.image import Image, ScalarImage, as_tensor
from ..ops.warp import identity_grid, warp, warp_backend
from ..utils import tracing
from ..utils.dtype import convert_dtype
from .translationanalysis import _to_gray

__all__ = ["FusedAnalysisPipeline"]


def _resolve_translation_analysis(registration):
    """TranslationAnalysis behind any public registration facade."""
    if registration is None:
        return None
    engine = getattr(registration, "_engine", registration)
    return getattr(engine, "translation_analysis", engine)


class FusedAnalysisPipeline:
    """correct + register + concentrate, frame by frame.

    Args:
        transformations: the correction chain (as ``Image(transformations=)``
            takes it); maximal runs of fusable geometric corrections run as
            one warp, any other correction through its ``correct_array``.
        registration: optional single-scale :class:`ImageRegistration`.
        analysis: optional :class:`ConcentrationAnalysis`.
        max_disp: displacement bound of the registration warp.
        single_warp: compose the trailing correction chain's pull-back field
            with the registration displacement on the coarse TPS grid, so
            correct + register costs one full-resolution colour warp plus a
            1-channel gray warp for the registration estimate.  Needs a
            registration and a trailing fusable chain without drift members.

    Call with an :class:`Image` or a raw array of the same layout; a series
    (``Image(series=True)`` or an (H, W, T, C) array) runs the single-frame
    program frame by frame and stacks the outputs on the last axis.
    """

    def __init__(
        self,
        transformations: Optional[Sequence] = None,
        registration=None,
        analysis=None,
        max_disp: int = 120,
        single_warp: bool = False,
    ) -> None:
        self.transformations = [
            t for t in (transformations or []) if t is not None and callable(t)
        ]
        self.registration = registration
        self.analysis = analysis
        self.max_disp = int(max_disp)
        self.single_warp = bool(single_warp)
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
            lone = j - i == 1 and (
                hasattr(chain[i], "pullback_field")
                or hasattr(chain[i], "pullback_translation")
            )
            if j - i >= 2 or lone:
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
        """``(frame, operands)`` for one frame signature.

        ``frame(data, ops, warp_impl="auto") -> (out, shifts, quality)``;
        ``operands`` is the nested dict of setup tensors (``field_k``,
        ``reg``, ``base``, and ``coarse_pos`` in the single-warp lane) that
        :mod:`darsia_tpu_torch.convert` can also build from the JAX
        package's operands.
        """
        stages, _ = self._stage_plan(input_shape, device)
        operands: dict = {}
        for k, (kind, obj) in enumerate(stages):
            if kind == "chain":
                operands[f"field_{k}"] = obj.field

        ta = self._translation_analysis
        aligner = estimate = est_geom = None
        if self.single_warp:
            chain = stages[-1][1] if stages and stages[-1][0] == "chain" else None
            if ta is None or chain is None:
                raise ValueError(
                    "single_warp needs a registration plus a trailing "
                    "fusable geometric correction chain."
                )
            if getattr(chain, "_dynamic", None) is not None:
                raise ValueError(
                    "single_warp does not support dynamic (drift) members "
                    "in the trailing chain; estimate drift separately."
                )
            estimate, operands["reg"], est_geom = ta.fused_estimator_parts(
                max_disp=self.max_disp
            )
            if tuple(chain.out_shape) != (est_geom["Hs"], est_geom["Ws"]):
                raise ValueError(
                    "single_warp: correction output shape does not match "
                    "the registration base shape."
                )
            operands["coarse_pos"] = ta.coarse_grid_positions(est_geom)
        elif ta is not None:
            aligner, operands["reg"] = ta.fused_aligner_parts(max_disp=self.max_disp)

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

        def correct(x, ops, warp_impl, stop):
            for k, (kind, obj, chain_apply) in enumerate(stage_fns[:stop]):
                if kind == "chain":
                    x = chain_apply(x, ops[f"field_{k}"], warp_impl)
                else:
                    x = obj.correct_array(x)
            return x

        def concentrate(x, ops):
            if analysis_fn is None:
                return x
            return analysis_fn(x, ops["base"]) if has_base else analysis_fn(x)

        if estimate is None:

            def frame(data, ops, warp_impl="auto"):
                dev = data.device
                with tracing.span("pipeline.correct", dev):
                    # Integer frames map to [0, 1] after the correction warp.
                    x = convert_dtype(correct(data, ops, warp_impl, None), torch.float32)
                shifts = quality = None
                if aligner is not None:
                    with tracing.span("pipeline.register", dev):
                        x, shifts, quality = aligner(x, ops["reg"], warp_impl)
                with tracing.span("pipeline.concentrate", dev):
                    return concentrate(x, ops), shifts, quality

            return frame, operands

        # Single-warp lane: the trailing chain's warp is replaced by (a) a
        # 1-channel gray warp feeding the registration estimate (gray o warp
        # == warp o gray for linear interpolation) and (b) a coarse-grid
        # composition of the chain field with the TPS displacement; both
        # fields are smooth, so the total displacement upsamples as the TPS
        # field alone does in the two-warp lane.
        k_last = len(stage_fns) - 1
        chain_disp = int(stages[-1][1].max_disp)
        total_disp = chain_disp + self.max_disp
        Hs, Ws, CH, CW = (est_geom[k] for k in ("Hs", "Ws", "CH", "CW"))
        reg_clip = est_geom["clip"]

        def frame(data, ops, warp_impl="auto"):
            dev = data.device
            with tracing.span("pipeline.correct", dev):
                # float32 BEFORE the one warp: unlike the two-warp lane, no
                # integer re-quantisation after the correction.
                x = convert_dtype(correct(data, ops, warp_impl, k_last), torch.float32)
            with tracing.span("pipeline.register", dev):
                field = ops[f"field_{k_last}"]
                gray = warp_backend(
                    _to_gray(x), field, order=1, max_disp=chain_disp, warp_impl=warp_impl
                )
                field_c, shifts, quality = estimate(gray, ops["reg"])
                field_c = field_c.clamp(-reg_clip, reg_clip)
                p_c = ops["coarse_pos"]
                comp = warp(field.permute(1, 2, 0), p_c - field_c, order=1, mode="nearest")
                total = comp.permute(2, 0, 1) - p_c
                if (CH, CW) != (Hs, Ws):
                    # jax.image.resize(method="linear"), edges included.
                    total = F.interpolate(
                        total[None], size=(Hs, Ws), mode="bilinear", align_corners=False
                    )[0]
                coords = identity_grid((Hs, Ws), x.device) + total
                x = warp_backend(
                    x, coords, order=1, max_disp=total_disp, warp_impl=warp_impl
                )
            with tracing.span("pipeline.concentrate", dev):
                return concentrate(x, ops), shifts, quality

        return frame, operands

    # -------------------------------------------------------------- calling

    def _signature(self, frame_shape: tuple, arr: torch.Tensor) -> tuple:
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
        return (frame_shape, arr.dtype, arr.device, versions, analysis_fp, reg_fp)

    def __call__(
        self,
        image,
        operands: Optional[dict] = None,
        warp_impl: str = "auto",
        device=None,
    ) -> Image:
        """Concentration image of one frame, or of each frame of a series.

        Args:
            image: :class:`Image`, tensor (runs on its device) or numpy array
                (runs on ``device``): (H, W, C), or (H, W, T, C) for a series.
            operands: setup products to use in place of the pipeline's own
                (same structure as :meth:`_build` returns, e.g. from
                :func:`darsia_tpu_torch.convert.operands_from_numpy`).
            warp_impl: "plain" routes the two-pass warp through the plain
                K1 version; for checks only.
            device: where a numpy input runs (default: the CUDA card; pass
                "cpu" to run on the CPU).

        """
        is_image = isinstance(image, Image)
        arr = image.img if is_image else as_tensor(image, device)
        series = image.series if is_image else arr.dim() == 4
        frames = arr.shape[2] if series else 1
        with tracing.span("pipeline.call", arr.device, frames=frames):
            frame_shape = tuple(arr.shape[:2] + arr.shape[3:] if series else arr.shape)
            key = self._signature(frame_shape, arr)
            entry = self._cache.get(key)
            if entry is None:
                # A new frame signature: operators see it as a build.
                with tracing.span("pipeline.build", arr.device):
                    tracing.count("pipeline.builds")
                    if len(self._cache) >= 4:
                        self._cache.pop(next(iter(self._cache)))
                    entry = self._build(frame_shape[:2], arr.dtype, arr.device)
                    self._cache[key] = entry
            frame, own_operands = entry
            ops = own_operands if operands is None else operands
            # A series is a plain frame loop (the JAX package maps the frame
            # over the time axis with lax.map, which is sequential too).
            outs = []
            for k in range(frames):
                with tracing.span("pipeline.frame", arr.device):
                    data = arr[:, :, k].contiguous() if series else arr
                    outs.append(frame(data, ops, warp_impl))
            with tracing.span("pipeline.assemble", arr.device):
                conc = torch.stack([o[0] for o in outs], dim=-1) if series else outs[0][0]
                shifts, quality = outs[-1][1:]
                ta = self._translation_analysis
                if ta is not None:
                    ta._stage_shifts(shifts, quality, ta._window_geometry()[1])
                return self._package(conc, image, series)

    def _package(self, concentration: torch.Tensor, image, series: bool) -> Image:
        meta = self._output_metadata(image)
        meta["series"] = series
        if concentration.dim() == 2 + int(series):
            return ScalarImage(concentration, **meta)
        return (type(image) if isinstance(image, Image) else Image)(concentration, **meta)

    def _output_metadata(self, image) -> dict:
        """Corrected-space metadata: the baseline's when there is one; a
        series keeps its times and dates."""
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
        if isinstance(image, Image) and image.series:
            meta["time"] = image.time
            meta["date"] = image.date
        return meta
