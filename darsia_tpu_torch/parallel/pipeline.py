"""Sharded analysis pipelines over batch x space meshes.

Counterpart of :mod:`darsia_tpu.parallel.pipeline`: the production loop
(per-image correction + restoration + signal conversion over a time series)
with

* the time-series **batch** split over the ``batch`` mesh axis, each mesh
  position running its frames;
* each image's rows split over the ``space`` mesh axis, the stencils
  exchanging halos (:func:`~darsia_tpu_torch.parallel.halo.halo_exchange`).

The JAX package writes each function as one ``shard_map`` body.  Here a body
is a plain function of one shard and its position (a Python int), and the
steps that need neighbours run over a *line* of shards (the positions along
the space axis) through :mod:`.collectives`.  Every warp is the exact gather
warp :func:`darsia_tpu_torch.ops.warp.warp`.
"""

from __future__ import annotations

import torch

from ..analysis.fusedpipeline import _resolve_translation_analysis
from ..ops.color import rgb_to_gray
from ..ops.fft import phase_correlation_prepared
from ..ops.solvers import operator_diagonal
from ..ops.warp import warp
from ..utils.derivatives import fv_laplace
from ..utils.dtype import as_torch_dtype, convert_dtype
from .collectives import all_gather
from .halo import halo_exchange, halo_exchange_2d
from .mesh import Mesh, Placement

__all__ = [
    "sharded_analysis_step",
    "sharded_production_pipeline",
    "sharded_tvd",
    "sharded_tvd_2d",
]


def _laplacian5(x: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian with edge-replicated closure over the last two axes."""
    up = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    down = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return up + down + left + right - 4.0 * x


def _sweep(x_ext, s_ext, mu: float, omega: float):
    """One damped-Jacobi sweep of (omega*x - ell*Lap x = omega*signal)."""
    ell = 2.0 * mu
    diag = omega + ell * 4.0
    residual = omega * s_ext - (omega * x_ext - ell * _laplacian5(x_ext))
    return x_ext + 0.8 * residual / diag


def _local_smooth_sweeps(x0, signal, mu: float, omega: float, iters: int):
    """Damped-Jacobi sweeps on one unsharded image (or a batch of them)."""
    x = x0
    for _ in range(iters):
        x = _sweep(x, signal, mu, omega)
    return x


def _halo_smooth_sweeps(xs: list, signals: list, mu: float, omega: float, iters: int) -> list:
    """The sweeps on a line of row shards (rows: axis -2); each sweep
    refreshes a 1-row halo.  The signal's halo does not change between
    sweeps, so it is exchanged once."""
    s_ext = halo_exchange(signals, 1, axis=-2)
    for _ in range(iters):
        x_ext = halo_exchange(xs, 1, axis=-2)
        xs = [_sweep(x, s, mu, omega)[..., 1:-1, :] for x, s in zip(x_ext, s_ext)]
    return xs


def _local_smooth_sweeps_2d(grid: list, signal: list, mu: float, omega: float, iters: int) -> list:
    """The sweeps on a (rows, cols) grid of tiles: corner-correct halos from
    both mesh axes before every stencil application."""
    s_ext = halo_exchange_2d(signal, 1)
    for _ in range(iters):
        x_ext = halo_exchange_2d(grid, 1)
        grid = [
            [_sweep(x, s, mu, omega)[1:-1, 1:-1] for x, s in zip(xr, sr)]
            for xr, sr in zip(x_ext, s_ext)
        ]
    return grid


def _space_axis(mesh: Mesh):
    """The mesh's second axis where it splits (size > 1), else None."""
    names = mesh.axis_names
    return names[1] if len(names) > 1 and mesh.shape[names[1]] > 1 else None


def _rows_of(shards: list, mesh: Mesh) -> list:
    """Shards of a 1- or 2-axis mesh as ``[batch position][space position]``."""
    return [[s] for s in shards] if mesh.devices.ndim == 1 else shards


def _from_rows(rows: list, mesh: Mesh) -> list:
    return [r[0] for r in rows] if mesh.devices.ndim == 1 else rows


def _per_device(mesh: Mesh, value: torch.Tensor) -> dict:
    """``value`` copied once to each distinct device of the mesh."""
    return {d: value.to(d) for d in set(mesh.devices.reshape(-1))}


def sharded_tvd_2d(
    mesh: Mesh,
    mu: float = 0.1,
    omega: float = 1.0,
    iters: int = 10,
    row_axis: str = "rows",
    col_axis: str = "cols",
):
    """Single-image smoother over a 2-D (rows, cols) space mesh: each
    position owns an (H/pr, W/pc) tile, halos (corners included) are
    exchanged every sweep.  Returns an ``(H, W) -> (H, W)`` callable (the
    result on the mesh's first device)."""
    if mesh.axis_names != (row_axis, col_axis):
        raise ValueError(f"mesh axes {mesh.axis_names}, want ({row_axis!r}, {col_axis!r})")
    placement = Placement(mesh, (row_axis, col_axis))

    def apply(img) -> torch.Tensor:
        tiles = placement.split(torch.as_tensor(img))
        return placement.join(_local_smooth_sweeps_2d(tiles, tiles, mu, omega, iters))

    return apply


def sharded_tvd(mesh: Mesh, mu: float = 0.1, omega: float = 1.0, iters: int = 10):
    """Sharded H1/TVD-style smoother: (B, H, W) -> (B, H, W).

    The batch axis is split over the mesh's first axis, the rows over its
    second (halo exchange per sweep) where that axis has more than one
    position.
    """
    space_axis = _space_axis(mesh)
    placement = Placement(mesh, (mesh.axis_names[0], space_axis, None))

    def smooth(line):
        if space_axis is None:
            return [_local_smooth_sweeps(s, s, mu, omega, iters) for s in line]
        return _halo_smooth_sweeps(line, line, mu, omega, iters)

    def apply(batch) -> torch.Tensor:
        rows = _rows_of(placement.split(torch.as_tensor(batch)), mesh)
        return placement.join(_from_rows([smooth(line) for line in rows], mesh))

    return apply


def sharded_analysis_step(
    mesh: Mesh,
    balance_matrix,
    scaling: float = 1.0,
    tvd_iters: int = 10,
    mu: float = 0.1,
):
    """Full sharded per-image analysis step.

    Per (sharded) image batch against a baseline split by space and
    replicated over the batch: colour balance (matrix product) -> positive
    difference -> gray reduction -> halo-exchanged smoothing -> linear
    model.  Returns ``(batch (B, H, W, 3), base (H, W, 3)) -> concentration
    (B, H, W)``.
    """
    space_axis = _space_axis(mesh)
    batch_axis = mesh.axis_names[0]
    data_placement = Placement(mesh, (batch_axis, space_axis, None, None))
    base_placement = Placement(mesh, (space_axis, None, None))
    out_placement = Placement(mesh, (batch_axis, space_axis, None))
    balance = _per_device(mesh, torch.as_tensor(balance_matrix, dtype=torch.float32))
    gray = _per_device(mesh, torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32))

    def signal_of(batch_local, base_local):
        m = balance[batch_local.device]
        balanced = batch_local.to(torch.float32) @ m
        base_balanced = base_local.to(torch.float32) @ m
        diff = (balanced - base_balanced[None]).clamp(min=0.0)
        return diff @ gray[diff.device]

    def step(line_batch, line_base):
        signals = [signal_of(b, s) for b, s in zip(line_batch, line_base)]
        if space_axis is None:
            restored = [_local_smooth_sweeps(s, s, mu, 1.0, tvd_iters) for s in signals]
        else:
            restored = _halo_smooth_sweeps(signals, signals, mu, 1.0, tvd_iters)
        return [scaling * r for r in restored]

    def apply(batch, base) -> torch.Tensor:
        rows = _rows_of(data_placement.split(torch.as_tensor(batch)), mesh)
        bases = _rows_of(base_placement.split(torch.as_tensor(base)), mesh)
        out = [step(line, base_line) for line, base_line in zip(rows, bases)]
        return out_placement.join(_from_rows(out, mesh))

    return apply


def _row_clamp(i0: int, lh: int, true_rows, device):
    """Row indices of a (lh + 2)-row halo-extended shard at global row
    ``i0`` clamped to the true image (pad-to-tile), or None where no row of
    the block lies past ``true_rows - 1``."""
    if true_rows is None or i0 + lh <= true_rows - 1:
        return None
    j = torch.arange(lh + 2, device=device)
    return (torch.clamp(j + (i0 - 1), max=true_rows - 1) - (i0 - 1)).clamp(0, lh + 1)


def _sharded_jacobi_h1(
    signals: list,
    mu: float,
    omega: float,
    maxiter: int,
    diags: list,
    true_rows=None,
) -> list:
    """Halo-aware replica of the production H1 restoration on a line of row
    shards.

    Reproduces ``H1_regularization(s, mu, omega, solver=Jacobi(maxiter))``
    (the zero-flux FV Laplacian, the exact two-colour diagonal, computed
    globally and split by rows, 0.8 damping, x0 = signal, rhs = omega *
    signal): each sweep refreshes a 1-row halo, whose edge replication at
    the global boundary is the zero-flux closure, so the interior arithmetic
    is the single-device program's element for element.

    With ``true_rows`` (pad-to-tile), every extended row is clamped to its
    value at ``min(global_row, true_rows - 1)``: the flux across the true
    bottom boundary is zero, as the unpadded program has it at row H - 1,
    and the pad rows (cropped by the caller) hold garbage.
    """
    lh = signals[0].shape[0]
    clamps = [_row_clamp(i * lh, lh, true_rows, s.device) for i, s in enumerate(signals)]

    def clamp(line):
        return [x if c is None else x.index_select(0, c) for x, c in zip(line, clamps)]

    rhs_ext = clamp([omega * x for x in halo_exchange(signals, 1, axis=0)])
    xs = signals
    for _ in range(maxiter):
        x_ext = clamp(halo_exchange(xs, 1, axis=0))
        xs = [
            x + 0.8 * (r - (omega * e - fv_laplace(e, dim=2, h=1.0, diffusion_coeff=mu)))[1:-1] / d
            for x, e, r, d in zip(xs, x_ext, rhs_ext, diags)
        ]
    return xs


def sharded_production_pipeline(
    mesh: Mesh,
    chain,
    analysis,
    image_shape: tuple,
    restoration: dict,
    registration=None,
    max_disp: int = 120,
    input_dtype=None,
    batch_axis: str = "batch",
    space_axis: str = "space",
):
    """The public per-frame program, split over a (batch, space) mesh.

    Subject: the fused correction chain
    (:func:`darsia_tpu_torch.corrections.fuse.fused_chain`: its composed
    coordinate field + warp) and the
    :class:`~darsia_tpu_torch.analysis.ConcentrationAnalysis` pipeline (the
    analysis object's own ``_diff_arrays`` / ``_reduce_signal`` /
    ``_clean_signal`` / ``_balance_signal`` / ``_convert_signal``, run per
    tile), frames split over ``batch_axis`` and rows over ``space_axis``.
    The chain's warp takes a ``chain.max_disp`` row halo, the H1
    restoration (``restoration = dict(mu=..., omega=..., maxiter=...)``,
    which must be the analysis's own) runs :func:`_sharded_jacobi_h1`.

    With ``registration`` (an :class:`~darsia_tpu_torch.analysis.ImageRegistration`
    or ``TranslationAnalysis`` on the corrected baseline) the fused
    registration lane runs between correction and analysis, as in
    :class:`~darsia_tpu_torch.analysis.fusedpipeline.FusedAnalysisPipeline`:
    the frame's gray image is gathered once per frame (one (H, W) float32
    ``all_gather``), the patch phase correlations are split over the space
    positions, the small TPS evaluation is replicated, and the displacement
    warp runs tile-local with a ``max_disp`` row halo.

    Rows that do not tile the space axis are zero-padded to the next
    multiple and cropped on return; the restoration clamps across the true
    bottom boundary so the real rows are unaffected.

    Constraints (raise ValueError): a shape-preserving chain, no drift
    member, no cleaning filter.  The frames' warps use the gather warp, the
    public lane's on the card use K1: compare with a reference that warps
    the same way for a tight gate.

    Returns ``(frames (B, H, W, C) input dtype, base (H, W, C) float32) ->
    concentration (B, H, W) float32`` on the mesh's first device.
    """
    H, W = image_shape
    ps = mesh.shape[space_axis]
    if ps <= 1:
        raise ValueError("sharded_production_pipeline needs a real space axis")
    if tuple(chain.out_shape) != (H, W):
        raise ValueError(
            "shape-preserving chain required: a crop is a static shift of the "
            "read window, not a stencil - fold it into imread"
        )
    if chain._dynamic is not None:
        raise ValueError("dynamic drift member not supported")
    if getattr(analysis, "threshold_cleaning_filter", None) is not None:
        raise ValueError("cleaning filter not supported")
    if mesh.axis_names != (batch_axis, space_axis):
        raise ValueError(f"mesh axes {mesh.axis_names}, want ({batch_axis!r}, {space_axis!r})")

    # Pad-to-tile: split H_pad rows, crop the output back to H.
    lh = -(-H // ps)
    H_pad = lh * ps
    pad = H_pad - H
    if pad >= lh:
        raise ValueError("padding must stay within the last tile")
    D = int(chain.max_disp)
    if D >= lh:
        raise ValueError("halo width must be smaller than the local row tile")

    mu = float(restoration["mu"])
    rest_omega = float(restoration["omega"])
    rest_iters = int(restoration["maxiter"])
    first = mesh.devices.reshape(-1)[0]
    # Exact global diagonal of (omega I - div(mu grad)), edge-padded: pad
    # rows never reach real rows.
    diag = operator_diagonal(rest_omega, mu, (H, W), 2, 1.0, first)
    field = chain.field.to(first, torch.float32)  # (2, H, W) global coordinates
    if pad:
        diag = torch.cat([diag, diag[-1:].expand(pad, W)], dim=0)
        field = torch.cat([field, field[:, -1:].expand(2, pad, W)], dim=1)
    # Operands placed once: split by rows, replicated over the batch axis.
    diags = Placement(mesh, (space_axis, None)).split(diag)
    fields = Placement(mesh, (None, space_axis, None)).split(field)
    in_dtype = torch.uint8 if input_dtype is None else as_torch_dtype(input_dtype)
    integer_in = not in_dtype.is_floating_point
    frame_placement = Placement(mesh, (batch_axis, space_axis, None, None))
    base_placement = Placement(mesh, (space_axis, None, None))
    out_placement = Placement(mesh, (batch_axis, space_axis, None))

    ta = _resolve_translation_analysis(registration)
    if ta is not None:
        reg = ta._fused_aligner_setup(max_disp=max_disp)
        geom = reg["geom"]
        if (geom["Hs"], geom["Ws"]) != (H, W):
            raise ValueError("registration baseline shape must match the corrected shape")
        Dreg = int(max_disp)
        if Dreg >= lh:
            raise ValueError("registration halo exceeds the local row tile")
        n_patch = int(reg["operands"]["centers"].shape[0])
        patches_shard = n_patch % ps == 0
        # Replicated operands: one copy per distinct device.
        reg_ops = {
            d: {k: v.to(d) for k, v in reg["operands"].items()}
            for d in set(mesh.devices.reshape(-1))
        }
        extract = ta._extract_windows

    def correct(line, field_line):
        """The fused chain's warp with a D-row halo; columns unsplit."""
        ext = halo_exchange([f.to(torch.float32) for f in line], D, axis=0)
        out = []
        for i, (e, fl) in enumerate(zip(ext, field_line)):
            i0 = float(i * lh)
            rows = fl[0].clamp(0.0, float(H - 1))
            cols = fl[1].clamp(0.0, float(W - 1))
            warped = warp(e, torch.stack([rows - (i0 - D), cols]), order=1, mode="constant")
            valid = (fl[0] >= 0) & (fl[0] <= H - 1) & (fl[1] >= 0) & (fl[1] <= W - 1)
            if warped.dim() == 3:
                valid = valid[..., None]
            corrected = torch.where(valid, warped, 0.0)
            if integer_in:
                corrected = torch.round(corrected)
            out.append(convert_dtype(corrected.to(in_dtype), torch.float32))
        return out

    def register(line):
        """Tile-local replica of the fused aligner (one all_gather per frame
        for the gray image, two for the patch shifts)."""
        win, CH, CW = geom["win"], geom["CH"], geom["CW"]
        grays = all_gather(
            [(rgb_to_gray(d) if d.dim() == 3 else d).to(torch.float32) for d in line], dim=0
        )
        shifts_l, quality_l = [], []
        for i, gray in enumerate(grays):
            ops = reg_ops[gray.device]
            centers, spectra = ops["centers"], ops["base_spectra"]
            if patches_shard:
                npp = n_patch // ps
                centers, spectra = centers[i * npp : (i + 1) * npp], spectra[i * npp : (i + 1) * npp]
            windows = extract(gray[:H], centers, win)
            s, q = phase_correlation_prepared(spectra, windows, win)
            shifts_l.append(s)
            quality_l.append(q)
        if patches_shard:
            shifts_l, quality_l = all_gather(shifts_l), all_gather(quality_l)
        ext = halo_exchange(line, Dreg, axis=0)
        out = []
        for i, (shifts, quality, e) in enumerate(zip(shifts_l, quality_l, ext)):
            ops = reg_ops[e.device]
            s = torch.where((quality > geom["tol"])[:, None], shifts, 0.0)
            zx = torch.zeros(geom["pad_x"], dtype=torch.float32, device=s.device)
            zy = torch.zeros(geom["pad_y"], dtype=torch.float32, device=s.device)
            dx = (ops["E_x"] @ (ops["Ainv_x"] @ torch.cat([s[:, 1], zx]))).reshape(CH, CW)
            dy = (ops["E_y"] @ (ops["Ainv_y"] @ torch.cat([s[:, 0], zy]))).reshape(CH, CW)
            # This tile's rows of the displacement field: the cell-centred
            # linear upsample of the public lane, at the tile's global rows.
            i0 = float(i * lh)
            rows_g = i0 + torch.arange(lh, dtype=torch.float32, device=s.device)
            cols_g = torch.arange(W, dtype=torch.float32, device=s.device)
            if (CH, CW) != (H, W):
                cr = (rows_g + 0.5) * (CH / H) - 0.5
                cc = (cols_g + 0.5) * (CW / W) - 0.5
                coords_c = torch.stack(torch.meshgrid(cr, cc, indexing="ij"), dim=0)
                dx_t = warp(dx, coords_c, order=1, mode="nearest")
                dy_t = warp(dy, coords_c, order=1, mode="nearest")
            else:
                take = rows_g.to(torch.int64).clamp(0, CH - 1)
                dx_t, dy_t = dx[take], dy[take]
            clip = geom["clip"]
            dx_t = dx_t.clamp(-clip, clip)
            dy_t = dy_t.clamp(-clip, clip)
            # Pull-back positions (global), warped tile-locally with a
            # Dreg-row halo, constant fill outside the true image.
            samp_r = rows_g[:, None] - dy_t
            samp_c = cols_g[None, :] - dx_t
            valid = (samp_r >= 0) & (samp_r <= H - 1) & (samp_c >= 0) & (samp_c <= W - 1)
            local_coords = torch.stack(
                [samp_r.clamp(0.0, float(H - 1)) - (i0 - Dreg), samp_c.clamp(0.0, float(W - 1))]
            )
            warped = warp(e, local_coords, order=1, mode="nearest")
            if warped.dim() == 3:
                valid = valid[..., None]
            out.append(torch.where(valid, warped, 0.0))
        return out

    def restore(line, diag_line):
        return _sharded_jacobi_h1(
            line, mu, rest_omega, rest_iters, diag_line, true_rows=H if pad else None
        )

    def one_frame(line, field_line, base_line, diag_line):
        data = correct(line, field_line)
        if ta is not None:
            data = register(data)
        diffs = [analysis._diff_arrays(d, b) for d, b in zip(data, base_line)]
        signals = [
            analysis._balance_signal(analysis._clean_signal(analysis._reduce_signal(d)))
            for d in diffs
        ]
        if analysis.first_restoration_then_model:
            smooth = restore(signals, diag_line)
            return [analysis._convert_signal(s, d) for s, d in zip(smooth, diffs)]
        nonsmooth = [analysis._convert_signal(s, d) for s, d in zip(signals, diffs)]
        return restore(nonsmooth, diag_line)

    def apply(frames, base) -> torch.Tensor:
        frames = torch.as_tensor(frames)
        base = torch.as_tensor(base)
        if frames.dtype != in_dtype:
            frames = frames.to(in_dtype)
        base = base.to(torch.float32)
        if pad:
            frames = torch.cat([frames, frames.new_zeros((frames.shape[0], pad) + tuple(frames.shape[2:]))], dim=1)
            base = torch.cat([base, base.new_zeros((pad,) + tuple(base.shape[1:]))], dim=0)
        frame_rows = frame_placement.split(frames)
        base_rows = base_placement.split(base)
        out = []
        for b, line in enumerate(frame_rows):
            frames_out = [
                one_frame([f[k] for f in line], fields[b], base_rows[b], diags[b])
                for k in range(line[0].shape[0])
            ]
            out.append([torch.stack([fo[i] for fo in frames_out]) for i in range(ps)])
        result = out_placement.join(out)
        return result[:, :H] if pad else result

    return apply
