"""Plain reference of the 4K analysis lane (configuration ``ff_lane_4k``).

One frame of uint8 RGB goes through the three stages that
``FusedAnalysisPipeline`` runs in its two-warp lane, written out here in
plain PyTorch and NumPy from the configuration's numbers alone:

1. correction: a fixed translation composed with the curvature correction
   (quadrilateral crop by a homography, then the vertical/horizontal bulge),
   applied as one bilinear warp of the frame, rounded back to uint8;
2. registration: 128 Hann-tapered windows phase-correlated against the
   corrected baseline's windows, the accepted patch shifts interpolated by a
   thin-plate spline (float64 on the host, evaluated on a coarse grid in
   float32), bilinearly upsampled and applied as one warp;
3. concentration: the positive difference to the corrected baseline, luma
   gray, the linear model, then H1 regularisation by damped Jacobi sweeps.

On a CUDA device every bilinear warp with a known displacement bound is the
two-pass row/column resample (a frozen copy of the plain version of the
port's kernel K1, below), as the port runs it there; on the CPU it is the
gather warp.  Nothing of the program is imported: every field, window
spectrum, spline matrix and the corrected baseline are worked out here.

``dtype`` sets the precision of the image-valued arrays (frames, registered
image, difference, signal, Jacobi iterates): float32 is the reference,
bfloat16 the control, which rounds each of them to bfloat16 as it is made.
Coordinates, spectra and spline matrices stay in float32 / float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GRAY = (0.299, 0.587, 0.114)
LANE = 128  # the window chain's tile width that fixes K1's index clamp
MAX_TWO_PASS_DISP = 1024


# ----------------------------------------------------------------- warps


def identity_grid(shape, device) -> torch.Tensor:
    axes = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=device) for n in shape],
        indexing="ij",
    )
    return torch.stack(axes, dim=0)


def gather_warp(data, coords, mode="constant"):
    """Bilinear resample of (H, W[, C]) ``data`` at (2, OH, OW) positions."""
    H, W = data.shape[:2]
    squeeze = data.dim() == 2
    flat = (data[..., None] if squeeze else data).reshape(H * W, -1).to(torch.float32)
    lo = torch.floor(coords)
    frac = coords - lo
    upper = torch.tensor([H - 1, W - 1], dtype=torch.float32, device=coords.device)
    valid = ((coords >= 0) & (coords <= upper.reshape(2, 1, 1))).all(dim=0)
    out = None
    for corner in range(4):
        dr, dc = corner & 1, (corner >> 1) & 1
        r = (lo[0] + dr).clamp(0.0, float(H - 1)).long()
        c = (lo[1] + dc).clamp(0.0, float(W - 1)).long()
        w = (frac[0] if dr else 1.0 - frac[0]) * (frac[1] if dc else 1.0 - frac[1])
        term = flat[(r * W + c).reshape(-1)].reshape(r.shape + (flat.shape[1],)) * w[..., None]
        out = term if out is None else out + term
    if mode == "constant":
        out = torch.where(valid[..., None], out, 0.0)
    return out[..., 0] if squeeze else out


def _k1_samples(cols, W_in, max_disp):
    """K1's index arithmetic: f32 offsets within a 128-wide tile's window
    chain, floor, the chain-edge clamp and the edge clamp."""
    W_out = cols.shape[1]
    pad = int(math.ceil(max_disp)) + 1
    rel_max = -(-(2 * pad + LANE + 1) // LANE) * LANE - 2
    j = torch.arange(W_out, device=cols.device)
    tile_start = (j // LANE) * LANE
    rel_f = cols.clamp(0.0, float(W_in - 1)) + (float(pad) - tile_start.to(torch.float32))
    base = torch.floor(rel_f)
    frac = rel_f - base
    p = tile_start + base.clamp(0.0, float(rel_max)).long() - pad
    return p.clamp(0, W_in - 1), (p + 1).clamp(0, W_in - 1), frac


def k1(data, cols, max_disp):
    """(C, R, W_in) x (R, W_out) -> (C, W_out, R): ``out[c, j, r] =
    data[c, r, cols[r, j]]``, lerp without FMA, output transposed."""
    C, R, W_in = data.shape
    i0, i1, frac = _k1_samples(cols, W_in, max_disp)
    v0 = torch.gather(data, 2, i0.expand(C, R, -1))
    v1 = torch.gather(data, 2, i1.expand(C, R, -1))
    return (v0 + frac * (v1 - v0)).transpose(1, 2).contiguous()


def two_pass_warp(data, coords, max_disp):
    """Separable warp: rows by the column field (indexed by clamped input
    rows), then columns by the row field; the outside filled with 0."""
    squeeze = data.dim() == 2
    x = (data[..., None] if squeeze else data).permute(2, 0, 1).to(torch.float32)
    C, H, W = x.shape
    OH = coords.shape[1]
    cols = coords[1]
    if OH != H:
        cols = cols[torch.arange(H, device=coords.device).clamp(0, OH - 1)]
    tmp = k1(x.contiguous(), cols.contiguous(), max_disp)
    out = k1(tmp, coords[0].transpose(0, 1).contiguous(), max_disp).permute(1, 2, 0)
    upper = torch.tensor([H - 1, W - 1], dtype=torch.float32, device=coords.device)
    valid = ((coords >= 0) & (coords <= upper.reshape(2, 1, 1))).all(dim=0)
    out = torch.where(valid[..., None], out, 0.0)
    return out[..., 0] if squeeze else out


def disp_bound(coords) -> int:
    ident = identity_grid(tuple(coords.shape[1:]), coords.device)
    return int(math.ceil(float((coords - ident).abs().max()))) + 1


def bilinear(data, coords, two_pass, max_disp=None):
    """The port's bilinear warp on this device: two-pass within the bound."""
    if two_pass:
        max_disp = disp_bound(coords) if max_disp is None else max_disp
        if max_disp <= MAX_TWO_PASS_DISP:
            return two_pass_warp(data, coords, max_disp)
    return gather_warp(data, coords)


# ---------------------------------------------------------- curvature field


def homography(src_rc, dst_rc) -> np.ndarray:
    """H with ``H @ [src, 1] ~ [dst, 1]`` from 4 point pairs (float64)."""
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src_rc, dst_rc)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i : 2 * i + 2] = [u, v]
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def crop_shape(H, W, width, height):
    aspect = float(width) / float(height)
    return min(H, int(1.0 / aspect * float(W))), min(W, int(aspect * float(H)))


def bulge_coordinates(shape, device, bulge):
    """The bulge's pull-back positions (Y, X) on an identity grid."""
    Y, X = identity_grid(shape, device)
    Ny, Nx = shape
    cx = round(Nx / 2) + bulge.get("horizontal_center_offset", 0)
    cy = round(Ny / 2) + bulge.get("vertical_center_offset", 0)
    hb = bulge.get("horizontal_bulge", 0.0)
    vb = bulge.get("vertical_bulge", 0.0)
    Xl, Yl = X - cx, Y - cy
    ymax, ymin, xmax, xmin = Yl.max(), Yl.min(), Xl.max(), Xl.min()
    Xm = Xl + hb * Xl * (ymax - Yl) * (Yl - ymin)
    Ym = Yl + vb * Yl * (xmax - Xl) * (Xl - xmin)
    return torch.stack([Ym + cy, Xm + cx], dim=0)


def correction_field(cfg, device, two_pass):
    """(field, max_disp): the translation then the curvature as one
    pull-back field from the frame to the cropped, bulge-corrected image."""
    H, W = cfg["frame"]["height"], cfg["frame"]["width"]
    crop, bulge = cfg["curvature"]["crop"], cfg["curvature"]["bulge"]
    h, w = crop_shape(H, W, crop["width"], crop["height"])
    # Curvature: the identity's coordinate images pushed through the crop
    # and the bulge, each a bilinear warp.
    dst = np.array([[0, 0], [h - 1, 0], [h - 1, w - 1], [0, w - 1]], dtype=np.float64)
    Hm = torch.as_tensor(
        homography(dst, np.floor(np.asarray(crop["pts_src"], dtype=np.float64))),
        dtype=torch.float32,
        device=device,
    )
    grid = identity_grid((h, w), device)
    homo = torch.cat([grid, torch.ones((1, h, w), device=device)], dim=0).reshape(3, -1)
    mapped = Hm @ homo
    crop_coords = (mapped[:2] / mapped[2:3]).reshape(2, h, w)
    bulge_coords = bulge_coordinates((h, w), device, bulge)
    Y, X = identity_grid((H, W), device)
    curv = []
    for pixels in (Y, X):
        pixels = bilinear(pixels, crop_coords, two_pass)
        pixels = bilinear(pixels, bulge_coords, two_pass)
        curv.append(pixels)
    curv = torch.stack(curv, dim=0)
    # The translation (x, y) pulls back from p - t; composed inside.
    tx, ty = (float(v) for v in cfg["translation"])
    shift = torch.tensor([-ty, -tx], dtype=torch.float32, device=device).reshape(2, 1, 1)
    trans = identity_grid((H, W), device) + shift
    field = torch.stack(
        [gather_warp(trans[d], curv, mode="nearest") for d in range(2)], dim=0
    )
    static = float((field - identity_grid((h, w), device)).abs().max())
    return field, int(math.ceil(static)) + 1


# ------------------------------------------------------------ registration


def hann2(shape, device):
    def hann(n):
        if n <= 1:
            return torch.ones(1, dtype=torch.float32, device=device)
        return torch.hann_window(n, periodic=False, dtype=torch.float32, device=device)

    return hann(shape[0])[:, None] * hann(shape[1])[None, :]


def spectra(windows, taper):
    x = windows.to(torch.float32)
    return torch.fft.rfft2((x - x.mean(dim=(-2, -1), keepdim=True)) * taper)


def phase_shifts(ref_spec, windows, taper, win, eps=1e-8):
    """Per-window (row, col) shift with a parabolic subpixel fit, and the
    correlation peak clipped to [0, 1]."""
    Hw, Ww = win
    cross = ref_spec * torch.conj(spectra(windows, taper))
    cross = cross / (cross.abs() + eps)
    r = torch.fft.irfft2(cross, s=(Hw, Ww))
    flat = r.reshape(r.shape[0], -1)
    peak = flat.argmax(dim=1)
    py, px = peak // Ww, peak % Ww
    n = torch.arange(r.shape[0], device=r.device)

    def fit(c, m, p):
        d = m - 2.0 * c + p
        off = torch.where(d.abs() > 1e-12, 0.5 * (m - p) / d, torch.zeros_like(d))
        return off.clamp(-0.5, 0.5)

    c = r[n, py, px]
    ry = py.to(torch.float32) + fit(c, r[n, (py - 1) % Hw, px], r[n, (py + 1) % Hw, px])
    rx = px.to(torch.float32) + fit(c, r[n, py, (px - 1) % Ww], r[n, py, (px + 1) % Ww])
    shift = torch.stack(
        [torch.where(ry > Hw / 2, ry - Hw, ry), torch.where(rx > Ww / 2, rx - Ww, rx)], dim=1
    )
    return shift, flat.gather(1, peak[:, None])[:, 0].clamp(0.0, 1.0)


def tps_kernel(d):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d > 0, d * d * np.log(np.where(d > 0, d, 1.0)), 0.0)


def tps_inverse(pts):
    n = pts.shape[0]
    K = tps_kernel(np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1))
    P = np.concatenate([np.ones((n, 1)), pts], axis=1)
    return np.linalg.inv(np.block([[K, P], [P.T, np.zeros((3, 3))]]))


def tps_eval(pts, query):
    Kq = tps_kernel(np.linalg.norm(query[:, None, :] - pts[None, :, :], axis=-1))
    return np.concatenate([Kq, np.ones((query.shape[0], 1)), query], axis=1)


class Registration:
    """Patch shifts -> thin-plate displacement -> one warp onto the base."""

    COARSE_THRESHOLD = 1 << 20
    COARSE_STRIDE = 16

    def __init__(self, base_gray, reg, device):
        Hs, Ws = base_gray.shape
        N = reg["N_patches"]
        pv = [int(np.ceil((Hs, Ws)[i] / N[i])) for i in range(2)]
        ov = [int(np.ceil(reg["rel_overlap"] * pv[i])) for i in range(2)]
        win = []
        for i in range(2):
            want = pv[i] + 2 * ov[i]
            p2 = 1 << max(0, int(np.round(np.log2(max(want, 1)))))
            if p2 < pv[i]:
                p2 <<= 1
            win.append(min((Hs, Ws)[i], p2))
        self.win = tuple(win)
        centers = np.asarray(
            [
                [
                    (i * pv[0] + min((i + 1) * pv[0], Hs)) / 2,
                    (j * pv[1] + min((j + 1) * pv[1], Ws)) / 2,
                ]
                for i in range(N[0])
                for j in range(N[1])
            ]
        )
        self.centers = torch.as_tensor(centers).to(device=device, dtype=torch.int32)
        self.taper = hann2(self.win, device)
        self.base_spec = spectra(self.windows(base_gray), self.taper)
        self.tol = float(reg["quality_tol"])
        self.max_disp = int(reg["max_disp"])
        self.shape = (Hs, Ws)

        cxy = np.stack([centers[:, 1], centers[:, 0]], axis=1).astype(np.float32)
        bx = [p for y in np.linspace(0, Hs, N[0] + 1) for p in ([0.0, y], [float(Ws), y])]
        by = [[x, float(Hs)] for x in np.linspace(0, Ws, N[1] + 1)]
        pts_x = np.concatenate([cxy, np.asarray(bx, dtype=np.float32)])
        pts_y = np.concatenate([cxy, np.asarray(by, dtype=np.float32)])
        self.pad = (len(bx) + 3, len(by) + 3)
        if Hs * Ws > self.COARSE_THRESHOLD:
            CH = max(2, -(-Hs // self.COARSE_STRIDE))
            CW = max(2, -(-Ws // self.COARSE_STRIDE))
            r_pos = (np.arange(CH) + 0.5) * (Hs / CH) - 0.5
            c_pos = (np.arange(CW) + 0.5) * (Ws / CW) - 0.5
        else:
            CH, CW = Hs, Ws
            r_pos, c_pos = np.arange(Hs, dtype=float), np.arange(Ws, dtype=float)
        self.coarse = (CH, CW)
        rr, cc = np.meshgrid(r_pos, c_pos, indexing="ij")
        query = np.stack([cc.ravel(), rr.ravel()], axis=1).astype(np.float32)
        s = 1.0 / float(max(Hs, Ws))

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32).to(device)

        self.A = (f32(tps_inverse(pts_x * s)), f32(tps_inverse(pts_y * s)))
        self.E = (f32(tps_eval(pts_x * s, query * s)), f32(tps_eval(pts_y * s, query * s)))

    def windows(self, arr):
        win = self.win
        w = torch.tensor(win, dtype=torch.long, device=arr.device)
        lim = torch.tensor([arr.shape[0] - win[0], arr.shape[1] - win[1]], device=arr.device)
        start = torch.minimum((self.centers.long() - w // 2).clamp(min=0), lim)
        rows = start[:, 0:1] + torch.arange(win[0], device=arr.device)
        cols = start[:, 1:2] + torch.arange(win[1], device=arr.device)
        return arr[rows[:, :, None], cols[:, None, :]]

    def displacement(self, gray):
        shifts, quality = phase_shifts(self.base_spec, self.windows(gray), self.taper, self.win)
        s = torch.where((quality > self.tol)[:, None], shifts, torch.zeros_like(shifts))
        dev = s.device
        vx = torch.cat([s[:, 1], torch.zeros(self.pad[0], device=dev)])
        vy = torch.cat([s[:, 0], torch.zeros(self.pad[1], device=dev)])
        CH, CW = self.coarse
        dx = (self.E[0] @ (self.A[0] @ vx)).reshape(CH, CW)
        dy = (self.E[1] @ (self.A[1] @ vy)).reshape(CH, CW)
        field = torch.stack([dy, dx], dim=0)
        if (CH, CW) != self.shape:
            field = F.interpolate(field[None], size=self.shape, mode="bilinear", align_corners=False)[0]
        clip = float(self.max_disp - 1)
        return field.clamp(-clip, clip)


# ------------------------------------------------------------ the lane


def luma(rgb):
    x = rgb.to(torch.float32)
    return torch.tensordot(x, torch.tensor(GRAY, dtype=torch.float32, device=x.device), dims=([-1], [0]))


def laplace(x, mu):
    """Zero-flux finite-volume ``div(mu grad x)`` on a 2-D grid."""
    out = torch.zeros_like(x)
    for ax in range(2):
        flux = mu * torch.diff(x, dim=ax)
        zshape = list(flux.shape)
        zshape[ax] = 1
        zero = torch.zeros(zshape, dtype=flux.dtype, device=flux.device)
        out = out + torch.diff(torch.cat([zero, flux, zero], dim=ax), dim=ax)
    return out / 1.0


class Lane:
    """``Lane(cfg, base_u8, dtype)(frame_u8) -> (OH, OW)`` concentration."""

    def __init__(self, cfg, base_u8: torch.Tensor, dtype=torch.float32):
        device = base_u8.device
        self.dtype = dtype
        self.two_pass = device.type == "cuda"
        self.field, self.max_disp = correction_field(cfg, device, self.two_pass)
        self.base = self.correct(base_u8)
        self.reg = Registration(luma(self.base), cfg["registration"], device)
        self.ident = identity_grid(self.reg.shape, device)
        conc = cfg["concentration"]
        self.scaling = float(conc["scaling"])
        self.mu, self.omega = float(conc["mu"]), float(conc["omega"])
        self.sweeps = int(conc["jacobi_maxiter"])
        self.damping = float(conc["jacobi_damping"])

    def q(self, x):
        """Round an image-valued array to the lane's precision."""
        if self.dtype == torch.float32:
            return x
        return x.to(self.dtype).to(torch.float32)

    def correct(self, frame_u8):
        out = bilinear(frame_u8.to(torch.float32), self.field, self.two_pass, self.max_disp)
        return torch.round(out).to(torch.uint8).to(torch.float32) / 255.0

    def operator(self, x):
        return self.omega * x - laplace(x, self.mu)

    def diagonal(self, shape, device):
        idx = torch.arange(shape[0], device=device)[:, None] + torch.arange(shape[1], device=device)[None, :]
        checker = (idx % 2).to(torch.float32)
        diag = torch.zeros(shape, dtype=torch.float32, device=device)
        for color in (checker, 1.0 - checker):
            diag = diag + color * self.operator(color)
        return diag

    def __call__(self, frame_u8):
        q = self.q
        x = q(self.correct(frame_u8))
        disp = self.reg.displacement(q(luma(x)))
        x = q(bilinear(x, self.ident - disp, self.two_pass, self.reg.max_disp))
        signal = q(luma(q((x - self.base).clamp(min=0))))
        signal = q(self.scaling * signal + 0.0)
        rhs = q(self.omega * signal)
        diag = self.diagonal(tuple(signal.shape), signal.device)
        u = signal
        for _ in range(self.sweeps):
            u = q(u + self.damping * (rhs - self.operator(u)) / diag)
        return u
