"""Patch-wise translation analysis: the fused registration lane.

Counterpart of the fused lane of :mod:`darsia_tpu.analysis.translationanalysis`.
All patch windows are cut as one batched tensor, a batched FFT phase
correlation against precomputed baseline spectra estimates every patch
shift, a prefactored thin-plate spline (TPS) turns the shifts into a smooth
displacement on a coarse grid, and one warp applies it.  The TPS systems are
solved and evaluated on the host in float64 and in unit-normalized
coordinates (at pixel scale the r^2 log r kernel cancels badly in f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.color import rgb_to_gray
from ..ops.fft import phase_correlation_prepared, prepare_phase_reference
from ..ops.warp import identity_grid, warp_backend

__all__ = ["TranslationAnalysis", "patch_centers"]


def _to_gray(arr: torch.Tensor) -> torch.Tensor:
    if arr.dim() == 3:
        return rgb_to_gray(arr.to(torch.float32))
    return arr.to(torch.float32)


def _tps_host(d: np.ndarray) -> np.ndarray:
    """Thin-plate kernel r^2 log r (numpy)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d > 0, d * d * np.log(np.where(d > 0, d, 1.0)), 0.0)


def _tps_system_inverse(pts: np.ndarray) -> np.ndarray:
    """Inverse of the TPS interpolation system [[K, P], [P^T, 0]]."""
    n = pts.shape[0]
    K = _tps_host(np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1))
    poly = np.concatenate([np.ones((n, 1)), pts], axis=1)
    A = np.block([[K, poly], [poly.T, np.zeros((3, 3))]])
    return np.linalg.inv(A)


def _tps_eval_matrix(pts: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Evaluation matrix E with ``E @ sol`` = TPS field at the query points."""
    Kq = _tps_host(np.linalg.norm(query[:, None, :] - pts[None, :, :], axis=-1))
    return np.concatenate([Kq, np.ones((query.shape[0], 1)), query], axis=1)


def patch_centers(num_voxels, num_patches) -> np.ndarray:
    """(N0 * N1, 2) voxel centres of non-overlapping patches, matrix order.

    The centre formula of :class:`darsia_tpu.image.patches.Patches`: patch
    size ``ceil(n / N)``, the last patch cut at the image edge.
    """
    pv = [int(np.ceil(num_voxels[i] / num_patches[i])) for i in range(2)]
    centers = [
        [
            (i * pv[0] + min((i + 1) * pv[0], num_voxels[0])) / 2,
            (j * pv[1] + min((j + 1) * pv[1], num_voxels[1])) / 2,
        ]
        for i in range(num_patches[0])
        for j in range(num_patches[1])
    ]
    return np.asarray(centers, dtype=float)


class TranslationAnalysis:
    """Estimate and apply a smooth displacement aligning images to a base."""

    #: Above this pixel count the TPS displacement is evaluated on a
    #: 1/COARSE_STRIDE grid and bilinearly upsampled (the field is smooth).
    COARSE_THRESHOLD = 1 << 20
    COARSE_STRIDE = 16

    def __init__(
        self, base, N_patches: list, rel_overlap: float, quality_tol: float = 0.03
    ) -> None:
        if base.space_dim != 2:
            raise NotImplementedError
        self.base = base
        self.N_patches = list(N_patches)
        self.rel_overlap = rel_overlap
        self.quality_tol = quality_tol
        self._pending_shifts = None
        self._fused = None

    def _window_geometry(self):
        """Power-of-two FFT window size and the patch centres."""
        nv = self.base.num_voxels
        pv = [int(np.ceil(nv[i] / self.N_patches[i])) for i in range(2)]
        ov = [int(np.ceil(self.rel_overlap * pv[i])) for i in range(2)]
        win = []
        for i in range(2):
            want = pv[i] + 2 * ov[i]
            p2 = 1 << max(0, int(np.round(np.log2(max(want, 1)))))
            if p2 < pv[i]:
                p2 <<= 1
            win.append(min(int(nv[i]), p2))
        return tuple(win), patch_centers(nv, self.N_patches)

    @staticmethod
    def _extract_windows(arr: torch.Tensor, centers: torch.Tensor, win) -> torch.Tensor:
        """(N, *win) windows of ``arr`` centred at ``centers``, clamped inside."""
        win_t = torch.tensor(win, dtype=torch.long, device=arr.device)
        limits = torch.tensor(
            [arr.shape[0] - win[0], arr.shape[1] - win[1]], device=arr.device
        )
        start = torch.minimum((centers.long() - win_t // 2).clamp(min=0), limits)
        rows = start[:, 0:1] + torch.arange(win[0], device=arr.device)
        cols = start[:, 1:2] + torch.arange(win[1], device=arr.device)
        return arr[rows[:, :, None], cols[:, None, :]]

    def _stage_shifts(self, shifts, qualities, centers) -> None:
        """Keep the last frame's per-patch shifts (device tensors, no sync)."""
        self._pending_shifts = (shifts, qualities, centers)

    # ------------------------------------------------------------ fused lane

    def _fused_aligner_setup(self, max_disp: int = 120) -> dict:
        """Device operands + static geometry of the fused aligner."""
        win, centers = self._window_geometry()
        base = self.base.img
        device = base.device
        centers_t = torch.as_tensor(centers).to(device=device, dtype=torch.int32)
        base_windows = self._extract_windows(_to_gray(base), centers_t, win)
        base_spectra = prepare_phase_reference(base_windows)

        Hs, Ws = (int(v) for v in self.base.num_voxels[:2])
        centers_xy = np.stack([centers[:, 1], centers[:, 0]], axis=1).astype(np.float32)
        # FluidFlower boundary conditions: zero x-displacement on the
        # vertical edges, zero y-displacement on the bottom edge.
        bc_x = [
            p
            for y in np.linspace(0, Hs, self.N_patches[0] + 1)
            for p in ([0.0, y], [float(Ws), y])
        ]
        bc_y = [[x, float(Hs)] for x in np.linspace(0, Ws, self.N_patches[1] + 1)]
        pts_x = np.concatenate([centers_xy, np.asarray(bc_x, dtype=np.float32)])
        pts_y = np.concatenate([centers_xy, np.asarray(bc_y, dtype=np.float32)])
        pad_x = len(bc_x) + 3
        pad_y = len(bc_y) + 3

        if Hs * Ws > self.COARSE_THRESHOLD:
            CH = max(2, -(-Hs // self.COARSE_STRIDE))
            CW = max(2, -(-Ws // self.COARSE_STRIDE))
            # Cell centres, where bilinear (align_corners=False) upsampling
            # expects its samples.
            r_pos = (np.arange(CH) + 0.5) * (Hs / CH) - 0.5
            c_pos = (np.arange(CW) + 0.5) * (Ws / CW) - 0.5
        else:
            CH, CW = Hs, Ws
            r_pos = np.arange(Hs, dtype=float)
            c_pos = np.arange(Ws, dtype=float)
        rr, cc = np.meshgrid(r_pos, c_pos, indexing="ij")
        query = np.stack([cc.ravel(), rr.ravel()], axis=1).astype(np.float32)

        # Unit-normalized coordinates: an exact rescale of the TPS
        # interpolant that keeps the f32 evaluation well conditioned.
        scale = 1.0 / float(max(Hs, Ws))

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32).to(device)

        operands = {
            "base_spectra": base_spectra,
            "centers": centers_t,
            "Ainv_x": f32(_tps_system_inverse(pts_x * scale)),
            "Ainv_y": f32(_tps_system_inverse(pts_y * scale)),
            "E_x": f32(_tps_eval_matrix(pts_x * scale, query * scale)),
            "E_y": f32(_tps_eval_matrix(pts_y * scale, query * scale)),
        }
        geom = {
            "win": win,
            "Hs": Hs,
            "Ws": Ws,
            "CH": CH,
            "CW": CW,
            "pad_x": pad_x,
            "pad_y": pad_y,
            "tol": float(self.quality_tol),
            "clip": float(max_disp - 1),
            "max_disp": int(max_disp),
        }
        return {"operands": operands, "geom": geom}

    def fused_estimator_parts(self, max_disp: int = 120):
        """``(estimate, operands, geom)``; ``estimate(gray, ops) -> (field_c,
        shifts, quality)`` gives the unclipped (2, CH, CW) displacement."""
        setup = self._fused_aligner_setup(max_disp=max_disp)
        operands, geom = setup["operands"], setup["geom"]
        win, CH, CW = geom["win"], geom["CH"], geom["CW"]
        pad_x, pad_y, tol = geom["pad_x"], geom["pad_y"], geom["tol"]
        extract = self._extract_windows

        def estimate(gray, ops):
            windows = extract(gray, ops["centers"], win)
            shifts, quality = phase_correlation_prepared(ops["base_spectra"], windows, win)
            s = torch.where((quality > tol)[:, None], shifts, torch.zeros_like(shifts))
            zx = torch.zeros(pad_x, dtype=torch.float32, device=s.device)
            zy = torch.zeros(pad_y, dtype=torch.float32, device=s.device)
            vx = torch.cat([s[:, 1], zx])
            vy = torch.cat([s[:, 0], zy])
            dx = (ops["E_x"] @ (ops["Ainv_x"] @ vx)).reshape(CH, CW)
            dy = (ops["E_y"] @ (ops["Ainv_y"] @ vy)).reshape(CH, CW)
            return torch.stack([dy, dx], dim=0), shifts, quality

        return estimate, operands, geom

    def fused_aligner_parts(self, max_disp: int = 120):
        """``(body, operands)``; ``body(data, ops, warp_impl="auto") ->
        (registered_f32, shifts, quality)``."""
        estimate, operands, geom = self.fused_estimator_parts(max_disp=max_disp)
        Hs, Ws, CH, CW = geom["Hs"], geom["Ws"], geom["CH"], geom["CW"]
        clip = geom["clip"]

        def aligner(data, ops, warp_impl="auto"):
            field, shifts, quality = estimate(_to_gray(data), ops)
            if (CH, CW) != (Hs, Ws):
                # Matches jax.image.resize(method="linear") when upsampling,
                # edges included (both hold the edge sample beyond the outer
                # cell centres).
                field = F.interpolate(
                    field[None], size=(Hs, Ws), mode="bilinear", align_corners=False
                )[0]
            field = field.clamp(-clip, clip)
            coords = identity_grid((Hs, Ws), data.device) - field
            out = warp_backend(
                data.to(torch.float32),
                coords,
                order=1,
                max_disp=max_disp,
                warp_impl=warp_impl,
            )
            return out, shifts, quality

        return aligner, operands

    def fused_align(self, img, max_disp: int = 120):
        """Register ``img`` onto the base through the fused lane."""
        key = (max_disp, img.device)
        if self._fused is None or self._fused[0] != key:
            self._fused = (key, *self.fused_aligner_parts(max_disp=max_disp))
        _, body, operands = self._fused
        out, shifts, quality = body(img.img, operands)
        self._stage_shifts(shifts, quality, self._window_geometry()[1])
        if not img.dtype.is_floating_point:
            out = torch.round(out)
        return type(img)(img=out.to(img.dtype), **img.metadata())
