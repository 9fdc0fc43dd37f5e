"""Patch-wise translation analysis: the flexible and fused registration lanes.

Counterpart of :mod:`darsia_tpu.analysis.translationanalysis`.
All patch windows are cut as one batched tensor, a batched FFT phase
correlation against precomputed baseline spectra estimates every patch
shift, a prefactored thin-plate spline (TPS) turns the shifts into a smooth
displacement on a coarse grid, and one warp applies it.  The TPS systems are
solved and evaluated on the host in float64 and in unit-normalized
coordinates (at pixel scale the r^2 log r kernel cancels badly in f32).
The flexible lane interpolates the accepted shifts with
:func:`~darsia_tpu_torch.utils.interpolation.rbf_interpolate` (float64, the
same rescale) and warps once by the evaluated field.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..corrections.shape.translation import _to_gray
from ..image.image import as_numpy, as_tensor
from ..ops.fft import phase_correlation_prepared, prepare_phase_reference
from ..ops.warp import identity_grid, warp_backend
from ..utils.interpolation import rbf_interpolate
from ..utils.optional import optional_module

__all__ = ["TranslationAnalysis", "patch_centers", "warp_image"]


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


def warp_image(img, field: torch.Tensor, sign: float, round_integers: bool):
    """``img`` warped by the pull-back ``identity + sign * field``: on CUDA
    through the two-pass kernel, with the bound read from the field (one
    device -> host read).  Integer outputs are rounded or, as the JAX
    package's multiscale lane casts them, truncated."""
    data = img.img
    field = field.to(data.device)
    coords = identity_grid(tuple(data.shape[:2]), data.device) + sign * field
    max_disp = int(math.ceil(field.abs().max().item())) + 1
    out = warp_backend(data.to(torch.float32), coords, order=1, max_disp=max_disp)
    if round_integers and not data.dtype.is_floating_point:
        out = torch.round(out)
    return type(img)(img=out.to(data.dtype), **img.metadata())


class TranslationAnalysis:
    """Estimate and apply a smooth displacement aligning images to a base.

    Two lanes: the flexible one (:meth:`find_translation` builds a host-side
    thin-plate interpolant of the accepted patch shifts, :meth:`translate_image`
    warps by it) and the fused one (:meth:`fused_align`, one device program
    per frame).  The fused lane's per-patch shifts stay on the device until
    a consumer of the interpolant (:attr:`translation`,
    :meth:`displacement_field`) asks for them.
    """

    #: Above this pixel count the TPS displacement is evaluated on a
    #: 1/COARSE_STRIDE grid and bilinearly upsampled (the field is smooth).
    COARSE_THRESHOLD = 1 << 20
    COARSE_STRIDE = 16

    def __init__(
        self,
        base,
        N_patches: list,
        rel_overlap: float,
        translation_estimator=None,
        mask=None,
        quality_tol: float = 0.03,
    ) -> None:
        if base.space_dim != 2:
            raise NotImplementedError
        self.N_patches = list(N_patches)
        self.rel_overlap = rel_overlap
        self.translation_estimator = translation_estimator
        self.quality_tol = quality_tol
        self.update_base(base)
        self.translation = lambda arg: np.zeros((2, len(np.atleast_2d(arg))))
        self.have_translation = np.zeros(tuple(self.N_patches), dtype=bool)
        self._displacement_data = None  # (pts_x, vals_x, pts_y, vals_y)
        self._pending_shifts = None  # device (shifts, qualities, centers)
        self.mask_base = mask

    # ------------------------------------------------------- lazy shift state

    def _stage_shifts(self, shifts, qualities, centers) -> None:
        """Keep the last frame's per-patch shifts (device tensors, no sync)."""
        self._pending_shifts = (shifts, qualities, centers)

    def _flush_pending_shifts(self) -> None:
        pending = self._pending_shifts
        if pending is not None:
            self._pending_shifts = None
            shifts, qualities, centers = pending
            self._ingest_shifts(
                shifts.detach().cpu().numpy(), qualities.detach().cpu().numpy(), centers
            )

    @property
    def translation(self):
        """``f(points (M, 2) in (x, y)) -> (2, M)`` displacement."""
        self._flush_pending_shifts()
        return self._translation

    @translation.setter
    def translation(self, fn) -> None:
        self._translation = fn

    @property
    def have_translation(self) -> np.ndarray:
        """(N0, N1) bools: which patches passed ``quality_tol``."""
        self._flush_pending_shifts()
        return self._have_translation

    @have_translation.setter
    def have_translation(self, value) -> None:
        self._have_translation = value

    # ---------------------------------------------------------------- setup

    def update_params(self, N_patches=None, rel_overlap=None) -> None:
        changed = False
        if N_patches is not None and list(N_patches) != self.N_patches:
            self.N_patches = list(N_patches)
            changed = True
        if rel_overlap is not None and rel_overlap != self.rel_overlap:
            self.rel_overlap = rel_overlap
            changed = True
        if changed:
            self.update_base_patches()

    def update_base(self, base) -> None:
        self.base = base
        self.update_base_patches()

    def update_base_patches(self) -> None:
        """Drop what depends on the base or the patch geometry."""
        self._base_spectra = None
        self._fused = None

    def load_image(self, img, mask=None) -> None:
        self.img = img
        self.mask_img = mask

    def deduct_translation_analysis(self, other: "TranslationAnalysis") -> None:
        """Copy the displacement state of another analysis."""
        self.translation = other.translation  # the property flushes other
        self.have_translation = other.have_translation.copy()
        self._pending_shifts = None
        self._displacement_data = other._displacement_data

    def add_translation_analysis(self, other: "TranslationAnalysis") -> None:
        """Compose: add another analysis' displacement to this one's."""
        first, second = self.translation, other.translation

        def combined(arg):
            return np.asarray(first(arg)) + np.asarray(second(arg))

        self.translation = combined

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

    # --------------------------------------------------------- flexible lane

    def find_translation(self, units: list = ["pixel", "pixel"]) -> tuple:
        """Estimate the displacement img -> base from the loaded image.

        The fused lane's window cut and batched FFT phase correlation, then
        the host-side interpolant of the accepted shifts (one device -> host
        read).  Returns ``(translation, success)``: the displacement as a
        callable (pixel or metric units per ``units``) and whether any patch
        passed ``quality_tol``.
        """
        if not all(unit in ("metric", "pixel") for unit in units):
            raise ValueError(f"units {units} are not metric or pixel")
        win, centers = self._window_geometry()
        device = self.img.img.device
        centers_t = torch.as_tensor(centers).to(device=device, dtype=torch.int32)
        # The base spectra are fixed across a time series: computed once.
        key = (win, centers.tobytes(), device)
        if self._base_spectra is None or self._base_spectra[0] != key:
            base_gray = _to_gray(self.base.img.to(device))
            spectra = prepare_phase_reference(
                self._extract_windows(base_gray, centers_t, win)
            )
            self._base_spectra = (key, spectra)
        windows = self._extract_windows(_to_gray(self.img.img), centers_t, win)
        spectra = self._base_spectra[1]
        shifts, qualities = phase_correlation_prepared(spectra, windows, win)
        return self._ingest_shifts(
            shifts.cpu().numpy(), qualities.cpu().numpy(), centers, units
        )

    def _ingest_shifts(
        self, shifts, qualities, centers, units=("pixel", "pixel")
    ) -> tuple:
        """Build the displacement interpolant from per-patch shifts (host).

        Patches failing ``quality_tol`` are dropped (the fused lane instead
        pins zero displacement at their centres).
        """
        self._pending_shifts = None  # a stale flush must not overwrite this
        have = qualities > self.quality_tol
        self.have_translation = have.reshape(tuple(self.N_patches))

        # Accepted displacements in (x, y) = (col, row) order.
        accepted = np.where(have)[0]
        centers_xy = np.stack([centers[:, 1], centers[:, 0]], axis=1)
        input_coords = [centers_xy[k] for k in accepted]
        disp_x = [float(shifts[k, 1]) for k in accepted]
        disp_y = [float(shifts[k, 0]) for k in accepted]
        if units[0] == "metric":
            coords = self.base.coordinatesystem.coordinate(centers)
            input_coords = [np.asarray(coords[k]) for k in accepted]
        if units[1] == "metric":
            # y runs against rows.
            vs = self.base.voxel_size
            disp_x = [d * vs[1] for d in disp_x]
            disp_y = [-d * vs[0] for d in disp_y]

        bc_coords_x, bc_vals_x = self.bc_x(units)
        bc_coords_y, bc_vals_y = self.bc_y(units)
        pts_x = np.array(input_coords + bc_coords_x)
        pts_y = np.array(input_coords + bc_coords_y)
        vals_x = np.array(disp_x + bc_vals_x)
        vals_y = np.array(disp_y + bc_vals_y)
        self._displacement_data = (pts_x, vals_x, pts_y, vals_y)

        def translation_callable(arg):
            arg = np.atleast_2d(np.asarray(arg, dtype=float))
            tx = rbf_interpolate(pts_x, vals_x, arg).numpy()
            ty = rbf_interpolate(pts_y, vals_y, arg).numpy()
            return np.array([tx, ty])

        self.translation = translation_callable
        return self.translation, bool(have.any())

    def bc_x(self, units: list) -> tuple:
        """Zero x-displacement on the vertical boundaries (overridable)."""
        boundary = []
        if units[0] == "metric":
            origin = np.asarray(self.base.origin)
            for y in np.linspace(0, self.base.dimensions[0], self.N_patches[0] + 1):
                boundary.append(origin + np.array([0, -y]))
                boundary.append(origin + np.array([self.base.dimensions[1], -y]))
        else:
            for y in np.linspace(0, self.base.num_voxels[0], self.N_patches[0] + 1):
                boundary.append(np.array([0.0, y]))
                boundary.append(np.array([float(self.base.num_voxels[1]), y]))
        return boundary, len(boundary) * [0.0]

    def bc_y(self, units: list) -> tuple:
        """Zero y-displacement on the bottom boundary (overridable)."""
        boundary = []
        if units[0] == "metric":
            origin = np.asarray(self.base.origin)
            for x in np.linspace(0, self.base.dimensions[1], self.N_patches[1] + 1):
                boundary.append(origin + np.array([x, -self.base.dimensions[0]]))
        else:
            for x in np.linspace(0, self.base.num_voxels[1], self.N_patches[1] + 1):
                boundary.append(np.array([x, float(self.base.num_voxels[0])]))
        return boundary, len(boundary) * [0.0]

    def return_patch_translation(self, reverse: bool = True, units: str = "metric"):
        """(N0, N1, 2) displacement (x, y) at the patch centres."""
        centers = patch_centers(self.base.num_voxels, self.N_patches)
        centers_xy = np.stack([centers[:, 1], centers[:, 0]], axis=1)
        disp = np.asarray(self.translation(centers_xy)).T
        if reverse:
            disp = -disp
        if units == "metric":
            vs = self.base.voxel_size
            disp = np.stack([disp[:, 0] * vs[1], -disp[:, 1] * vs[0]], axis=1)
        return disp.reshape((*self.N_patches, 2))

    def plot_translation(self, reverse: bool = False, scaling: float = 1.0, mask=None) -> None:
        """Quiver plot of the patch-centre displacements (pixels) over the
        base image; the background is masked (and a colour base clipped to
        [0, 1]) on the base's device and copied to the host once."""
        plt = optional_module("matplotlib.pyplot", "TranslationAnalysis.plot_translation")
        flat = self.return_patch_translation(reverse=reverse, units="pixel").reshape(-1, 2)
        centers = patch_centers(self.base.num_voxels, self.N_patches)
        fig, ax = plt.subplots(num="translation analysis")
        base = self.base.img
        if mask is not None:
            keep = as_tensor(mask.img, base.device).to(torch.bool)
            zero = torch.zeros((), dtype=base.dtype, device=base.device)
            base = torch.where(keep[..., None] if base.dim() == 3 else keep, base, zero)
        ax.imshow(as_numpy(base if base.dim() == 2 else base.clamp(0, 1)))
        ax.quiver(
            centers[:, 1],
            centers[:, 0],
            scaling * flat[:, 0],
            -scaling * flat[:, 1],
            color="white",
            angles="xy",
            scale_units="xy",
            scale=1,
        )
        plt.show()

    def _grid_positions(self, H: int, W: int, device) -> tuple:
        """(CH, CW, row positions, col positions) of the TPS evaluation grid,
        float32: every pixel, or above :attr:`COARSE_THRESHOLD` the cell
        centres of a 1/:attr:`COARSE_STRIDE` grid, where bilinear
        (align_corners=False) upsampling expects its samples."""
        if H * W > self.COARSE_THRESHOLD:
            CH = max(2, -(-H // self.COARSE_STRIDE))
            CW = max(2, -(-W // self.COARSE_STRIDE))
        else:
            CH, CW = H, W
        r_pos = torch.arange(CH, dtype=torch.float32, device=device)
        c_pos = torch.arange(CW, dtype=torch.float32, device=device)
        if (CH, CW) != (H, W):
            r_pos = (r_pos + 0.5) * (H / CH) - 0.5
            c_pos = (c_pos + 0.5) * (W / CW) - 0.5
        return CH, CW, r_pos, c_pos

    def displacement_field(self, shape) -> torch.Tensor:
        """Dense (2, H, W) float32 displacement in (row, col) voxel units, on
        the base's device; zero before any estimate."""
        self._flush_pending_shifts()
        device = self.base.img.device
        H, W = (int(s) for s in shape)
        if self._displacement_data is None:
            return torch.zeros((2, H, W), dtype=torch.float32, device=device)
        pts_x, vals_x, pts_y, vals_y = self._displacement_data
        CH, CW, r_pos, c_pos = self._grid_positions(H, W, device)
        rr, cc = torch.meshgrid(r_pos, c_pos, indexing="ij")
        query = torch.stack([cc.reshape(-1), rr.reshape(-1)], dim=1)
        dx = rbf_interpolate(pts_x, vals_x, query).reshape(CH, CW)
        dy = rbf_interpolate(pts_y, vals_y, query).reshape(CH, CW)
        field = torch.stack([dy, dx], dim=0)
        if (CH, CW) != (H, W):
            # jax.image.resize(method="linear"), edges included.
            field = F.interpolate(
                field[None], size=(H, W), mode="bilinear", align_corners=False
            )[0]
        return field

    def translate_image(self, img=None, reverse: bool = True):
        """Warp an image (default: the loaded one) by the estimated
        displacement; integer images are rounded."""
        if img is None:
            img = self.img
        disp = self.displacement_field(tuple(img.img.shape[:2]))
        return warp_image(img, disp, -1.0 if reverse else 1.0, round_integers=True)

    def __call__(self, img, mask=None):
        """The flexible lane: estimate the displacement of ``img``, return it
        aligned to the base."""
        self.load_image(img, mask=mask)
        self.find_translation()
        return self.translate_image()

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
        bc_x, _ = self.bc_x(["pixel", "pixel"])
        bc_y, _ = self.bc_y(["pixel", "pixel"])
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

    def coarse_grid_positions(self, geom: dict) -> torch.Tensor:
        """(2, CH, CW) row/col positions of the coarse TPS evaluation grid.

        Cell centres, where bilinear (align_corners=False) upsampling expects
        its samples, so composing consumers sample the field exactly where
        :meth:`fused_estimator_parts` evaluated it.  Computed in f32, as the
        JAX package does.
        """
        device = self.base.img.device
        _, _, r_pos, c_pos = self._grid_positions(geom["Hs"], geom["Ws"], device)
        return torch.stack(torch.meshgrid(r_pos, c_pos, indexing="ij"), dim=0)

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

    def build_fused_aligner(self, max_disp: int = 120):
        """``aligner(data) -> (registered_f32, shifts, qualities)``: the body
        of :meth:`fused_aligner_parts` with its operands bound, for (H, W) or
        (H, W, C) tensors of the base's spatial shape on the base's device.

        Patches failing ``quality_tol`` pin zero displacement at their
        centres (the JAX package's fused lane); on CUDA within ``max_disp``
        one call launches K1 twice.
        """
        body, operands = self.fused_aligner_parts(max_disp=max_disp)
        return lambda data: body(data, operands)

    def fused_align(self, img, max_disp: int = 120):
        """Register ``img`` onto the base through the fused lane."""
        key = (max_disp, img.device)
        if self._fused is None or self._fused[0] != key:
            self._fused = (key, self.build_fused_aligner(max_disp=max_disp))
        out, shifts, quality = self._fused[1](img.img)
        self._stage_shifts(shifts, quality, self._window_geometry()[1])
        if not img.dtype.is_floating_point:
            out = torch.round(out)
        return type(img)(img=out.to(img.dtype), **img.metadata())
