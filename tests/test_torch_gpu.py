"""K1, K2 and K3, the hand-written CUDA kernels, against their plain versions.

Needs a CUDA card (marked ``gpu``; skipped elsewhere).  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from darsia_tpu_torch.ops import warp2pass
from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]


def _rows_case(C, R, W_in, D, W_out=None, seed=7):
    rng = np.random.default_rng(seed)
    W_out = W_out or W_in
    data = rng.standard_normal((C, R, W_in)).astype(np.float32)
    jj = np.broadcast_to(np.arange(W_out, dtype=np.float32), (R, W_out))
    cols = (jj + rng.uniform(-D, D, (R, W_out))).astype(np.float32)
    return torch.from_numpy(data).cuda(), torch.from_numpy(cols).cuda()


@pytest.mark.parametrize(
    "C,R,W_in,D,W_out",
    [
        (3, 64, 300, 7, None),
        (3, 130, 515, 40, None),
        (3, 96, 257, 121, None),
        (1, 33, 200, 3, 150),  # ragged tiles, C = 1, W_out < W_in
        (2, 40, 90, 2, 300),  # bound violated: chain-edge clamp
    ],
)
def test_kernel_matches_plain(C, R, W_in, D, W_out):
    data, cols = _rows_case(C, R, W_in, D, W_out)
    if W_out == 300:
        cols = cols * 1.5  # displacements far beyond D
    before = warp2pass.launch_count
    out = warp2pass.warp_rows_t(data, cols, D)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 1
    ref = warp2pass.warp_rows_t_reference(data, cols, D)
    assert out.shape == ref.shape == (C, cols.shape[1], R)
    assert (out - ref).abs().max().item() <= 1e-6
    # Same index arithmetic and a lerp without FMA on both sides: bitwise.
    assert torch.equal(out, ref)
    assert warp2pass.launch_count == before + 1


# K1 tiles are 32 columns j by 56 stored rows r, stored as runs that start on a
# 32-byte sector (R % 8 decides where), for groups of up to 4 channels, on a
# persistent grid.
@pytest.mark.parametrize(
    "C,R,W_in,D,W_out,field",
    [
        (3, 100, 301, 5, 203, "random"),  # R % 8 == 4; W_out ragged
        (3, 101, 130, 5, 67, "random"),  # R, W_out odd: planes at other sector offsets
        (1, 36, 97, 3, 71, "random"),  # C = 1, every extent ragged
        (5, 70, 200, 9, 150, "random"),  # C above the channel group (4 + 1)
        (8, 40, 100, 4, 90, "random"),  # two full channel groups
        (3, 1030, 2051, 120, 1999, "random"),  # more tiles than the persistent grid
        (3, 1030, 2051, 120, 1999, "smooth"),  # a smooth field far inside its bound
        (3, 96, 257, 7, 257, "violated"),  # cols x 1.5: chain-edge clamp
        (2, 5, 40, 3, 7, "random"),  # fewer rows than the 8-row halo
    ],
)
def test_kernel_geometry_matches_plain(C, R, W_in, D, W_out, field):
    data, cols = _rows_case(C, R, W_in, D, W_out, seed=C + R)
    if field == "smooth":
        jj = torch.arange(W_out, dtype=torch.float32, device="cuda")
        rr = torch.arange(R, dtype=torch.float32, device="cuda")[:, None]
        cols = (jj + 2.5 * torch.sin(jj / 97.0 + rr / 61.0)).contiguous()
    elif field == "violated":
        cols = (cols * 1.5).contiguous()
    before = warp2pass.launch_count
    out = warp2pass.warp_rows_t(data, cols, D)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 1
    ref = warp2pass.warp_rows_t_reference(data, cols, D)
    assert out.shape == ref.shape == (C, W_out, R)
    assert torch.equal(out, ref)


def test_kernel_walks_more_items_than_its_grid():
    geometry = warp2pass.warp_rows_t_geometry(3, 1030, 1999)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert geometry["grid"] == sms * geometry["blocks_per_sm"]
    assert geometry["items"] > geometry["grid"]
    assert geometry["smem_bytes"] > 0


def test_plain_impl_on_cuda_counts_no_launch():
    data, cols = _rows_case(3, 64, 300, 7)
    before = warp2pass.launch_count
    out = warp2pass.warp_rows_t(data, cols, 7, impl="plain")
    assert out.is_cuda and warp2pass.launch_count == before


def test_kernel_refuses_noncontiguous_input():
    data, cols = _rows_case(3, 64, 300, 7)
    with pytest.raises(ValueError):
        warp2pass.warp_rows_t(data, cols.t().contiguous().t(), 7)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize(
    "R,W_in,D,W_out",
    [
        (64, 300, 7, None),
        (130, 515, 40, None),
        (96, 257, 121, None),
        (33, 200, 3, 150),  # ragged tiles, W_out < W_in
        (40, 90, 2, 300),  # bound violated: chain-edge clamp
    ],
)
def test_row_kernels_match_plain(R, W_in, D, W_out, ring):
    data, cols = _rows_case(1, R, W_in, D, W_out)
    data = data[0]
    if W_out == 300:
        cols = cols * 1.5  # displacements far beyond D
    counts = (warp2pass.rows_launch_count, warp2pass.ring_launch_count)
    out = warp2pass.warp_rows(data, cols, D, ring=ring)
    torch.cuda.synchronize()
    want = (counts[0] + (not ring), counts[1] + ring)
    assert (warp2pass.rows_launch_count, warp2pass.ring_launch_count) == want
    ref = warp2pass.warp_rows_reference(data, cols, D)
    assert out.shape == ref.shape == cols.shape
    assert (out - ref).abs().max().item() <= 1e-6
    assert torch.equal(out, ref)
    other = warp2pass.warp_rows(data, cols, D, ring=not ring)
    torch.cuda.synchronize()
    assert torch.equal(out, other)  # K2 == K3


@pytest.mark.parametrize("ring", [False, True])
def test_row_kernels_plain_impl_counts_no_launch(ring):
    data, cols = _rows_case(1, 64, 300, 7)
    counts = (warp2pass.rows_launch_count, warp2pass.ring_launch_count)
    out = warp2pass.warp_rows(data[0], cols, 7, ring=ring, impl="plain")
    assert out.is_cuda
    assert (warp2pass.rows_launch_count, warp2pass.ring_launch_count) == counts


@pytest.mark.parametrize("ring", [False, True])
def test_row_kernels_refuse_noncontiguous_input(ring):
    data, cols = _rows_case(1, 64, 300, 7)
    with pytest.raises(ValueError):
        warp2pass.warp_rows(data[0], cols.t().contiguous().t(), 7, ring=ring)
    with pytest.raises(ValueError):
        warp2pass.warp_rows(data[0][:, ::2], cols[:, :150].contiguous(), 7, ring=ring)


def test_two_pass_warp_on_cuda_matches_cpu_plain():
    rng = np.random.default_rng(3)
    H, W = 150, 210
    img = rng.random((H, W, 3)).astype(np.float32)
    coords = identity_grid((H, W), "cpu") + torch.from_numpy(
        (2.0 * np.sin(np.arange(H * W).reshape(1, H, W) / 53.0)).astype(np.float32)
    )
    cpu = warp_backend(torch.from_numpy(img), coords, max_disp=4, force="kernel")
    before = warp2pass.launch_count
    gpu = warp_backend(torch.from_numpy(img).cuda(), coords.cuda(), max_disp=4)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 2
    assert (gpu.cpu() - cpu).abs().max().item() <= 1e-6


def _textured_cuda(shape=(192, 256), shift=(3, -4), seed=5):
    """A smooth random texture and its rolled copy, as images on the card."""
    import darsia_tpu_torch as dt
    from scipy.ndimage import uniform_filter

    smooth = uniform_filter(np.random.default_rng(seed).random(shape), 7).astype(np.float32)
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    probe = np.roll(smooth, shift, axis=(0, 1))
    meta = {"width": 1.0, "height": 1.0}
    return dt.ScalarImage(smooth, **meta), dt.ScalarImage(probe, **meta)


def test_flexible_lane_warps_through_k1():
    import darsia_tpu_torch as dt

    base, probe = _textured_cuda()
    assert base.img.is_cuda
    ta = dt.TranslationAnalysis(base, N_patches=[3, 4], rel_overlap=0.3, quality_tol=0.01)
    ta.load_image(probe)
    ta.find_translation()
    before = warp2pass.launch_count
    out = ta.translate_image()
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 2
    disp = ta.displacement_field((192, 256))
    coords = identity_grid((192, 256), "cuda") - disp
    max_disp = int(np.ceil(disp.abs().max().item())) + 1
    plain = warp_backend(probe.img, coords, max_disp=max_disp, warp_impl="plain")
    assert torch.equal(out.img, plain)


def test_series_correction_is_one_k1_pair():
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.corrections.fuse import fused_chain

    H, W, T = 200, 300, 4
    series = torch.from_numpy(
        (np.random.default_rng(2).random((H, W, T, 3)) * 255).astype(np.uint8)
    ).cuda()
    chain = fused_chain(
        [dt.TranslationCorrection([1.5, -2.0]), dt.TranslationCorrection([0.25, 3.0])],
        (H, W),
        "cuda",
    )
    before = warp2pass.launch_count
    folded = chain.correct_series_array(series, 2)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 2
    plain = chain.apply_fn(torch.uint8)(series.reshape(H, W, -1), chain.field, "plain")
    assert torch.equal(folded, plain.reshape(folded.shape))
    for k in range(T):
        assert torch.equal(folded[:, :, k], chain.correct_array(series[:, :, k].contiguous()))


def test_multiscale_warps_through_k1():
    import darsia_tpu_torch as dt

    base, probe = _textured_cuda(shift=(2, 3))
    reg = dt.ImageRegistration(base, N_patches=[2, 2], rel_overlap=0.3, quality_tol=0.01, num_levels=3)
    before = warp2pass.launch_count
    out = reg(probe)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 6  # one warp per level
    field = reg.displacement()
    coords = identity_grid((192, 256), "cuda") - field
    max_disp = int(np.ceil(field.abs().max().item())) + 1
    plain = warp_backend(probe.img, coords, max_disp=max_disp, warp_impl="plain")
    assert torch.equal(out.img, plain)


def _drift_chain_scene(H=200, W=300, T=4):
    """A smooth RGB baseline on the card, a drift + curvature chain on it and
    a series of frames rolled differently."""
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.corrections.fuse import fused_chain
    from scipy.ndimage import uniform_filter

    rng = np.random.default_rng(11)
    base = np.stack([uniform_filter(rng.random((H, W)), 5) for _ in range(3)], axis=-1)
    base_u8 = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.uint8)
    drift = dt.DriftCorrection(torch.from_numpy(base_u8).cuda(), {"roi": (slice(20, 180), slice(30, 270))})
    curv = dt.CurvatureCorrection(
        config={
            "crop": {"pts_src": [[3, 4], [H - 5, 2], [H - 3, W - 4], [2, W - 3]], "width": 1.5, "height": 1.0},
            "bulge": {"horizontal_bulge": -1e-7, "vertical_bulge": -2e-7},
        }
    )
    chain = fused_chain([drift, curv], (H, W), "cuda")
    frames = [np.roll(base_u8, (1 + k, 2 - k), axis=(0, 1)) for k in range(T)]
    series = torch.from_numpy(np.stack(frames, axis=2)).cuda()
    return chain, series


def _recorded_k1_calls(fn):
    calls, wrapper = [], warp2pass.warp_rows_t

    def record(data, cols, max_disp, impl="auto"):
        calls.append((data, cols, max_disp))
        return wrapper(data, cols, max_disp, impl)

    warp2pass.warp_rows_t = record
    try:
        out = fn()
    finally:
        warp2pass.warp_rows_t = wrapper
    torch.cuda.synchronize()
    return out, calls


def test_k1_at_the_drift_chain_bound_matches_plain():
    """The drift chain's K1 pair runs at its own bound (static + 1 + 64),
    bitwise against the plain version."""
    chain, series = _drift_chain_scene()
    frame = series[:, :, 0].contiguous()
    assert chain.max_disp == int(np.ceil(chain.static_disp)) + 1 + 64
    before = warp2pass.launch_count
    out, calls = _recorded_k1_calls(lambda: chain.correct_array(frame))
    assert warp2pass.launch_count == before + 2 and len(calls) == 2
    for data, cols, D in calls:
        assert D == chain.max_disp and data.shape[0] == 3
        assert torch.equal(warp2pass.warp_rows_t(data, cols, D), warp2pass.warp_rows_t_reference(data, cols, D))
    plain = chain.apply_fn(torch.uint8)(frame, chain.field, "plain")
    assert torch.equal(out, plain)


def test_drifting_series_is_one_k1_pair_per_frame():
    chain, series = _drift_chain_scene()
    T = series.shape[2]
    before = warp2pass.launch_count
    out, calls = _recorded_k1_calls(lambda: chain.correct_series_array(series, 2))
    assert warp2pass.launch_count == before + 2 * T and len(calls) == 2 * T
    for data, cols, D in calls:
        assert torch.equal(warp2pass.warp_rows_t(data, cols, D), warp2pass.warp_rows_t_reference(data, cols, D))
    for k in range(T):
        assert torch.equal(out[:, :, k], chain.correct_array(series[:, :, k].contiguous()))


def test_checker_crop_warps_through_k1():
    """The colour checker's crop is shaped on the card: its warp to the
    checker's aspect ratio is one K1 pair, bitwise against the plain version,
    and the swatches agree with the CPU's."""
    import darsia_tpu_torch as dt

    ref = dt.ColorCheckerAfter2014().swatches_rgb
    crop = torch.from_numpy(np.kron(ref, np.ones((60, 60, 1))).astype(np.float32))
    before = warp2pass.launch_count
    swatches, calls = _recorded_k1_calls(lambda: dt.CustomColorChecker(image=crop.cuda()).swatches_rgb)
    assert warp2pass.launch_count == before + 2 and len(calls) == 2
    for data, cols, D in calls:
        assert torch.equal(warp2pass.warp_rows_t(data, cols, D), warp2pass.warp_rows_t_reference(data, cols, D))
    # Flat swatches: the two warps agree inside them.
    assert np.abs(swatches - dt.CustomColorChecker(image=crop).swatches_rgb).max() <= 1e-5


def _bench_like(h=240, w=320, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def test_shape_zoo_runs_on_the_card_by_default_and_matches_the_cpu():
    """numpy input goes to the card; a nearest-voxel warp of a host-built (or
    product-summed) field picks the same voxels there as on the CPU."""
    import darsia_tpu_torch as dt

    frame = _bench_like()
    image = dt.OpticalImage(frame, width=3.2, height=2.4)
    assert image.img.device.type == "cuda"
    cs = image.coordinatesystem
    src = np.asarray(cs.coordinate([[20, 30], [200, 40], [190, 300], [30, 280]]))
    rng = np.random.default_rng(12)
    dst_p = rng.random((16, 2)) * np.array([3.2, 2.4])
    src_p = (dst_p @ np.array([[1.002, 0.003], [-0.002, 0.999]]).T + 0.004) / (dst_p @ [2e-3, 1e-3] + 1)[:, None]
    corrections = [
        dt.RotationCorrection([120, 160], rotations=[np.deg2rad(0.5)]),
        dt.AffineCorrection(cs, cs, dt.make_coordinate(src), dt.make_coordinate(src + 0.03)),
        dt.GeneralizedPerspectiveCorrection(cs, cs, dt.make_coordinate(src_p), dt.make_coordinate(dst_p)),
    ]
    before = warp2pass.launch_count
    for correction in corrections:
        out = correction(image)
        assert out.img.device.type == "cuda" and out.img.dtype == torch.uint8
        on_cpu = correction.correct_array(torch.from_numpy(frame))
        assert on_cpu.device.type == "cpu" and torch.equal(out.img.cpu(), on_cpu)
    assert warp2pass.launch_count == before  # gather warps only


def test_piecewise_perspective_warps_through_k1():
    import darsia_tpu_torch as dt

    frame = _bench_like().astype(np.float32) / 255.0
    image = dt.OpticalImage(frame, width=3.2, height=2.4)
    patches = dt.Patches(image, [3, 4], rel_overlap=0.1)
    assert patches(1, 2).img.device.type == "cuda"
    assert (patches.blend_and_assemble().img - image.img).abs().max().item() <= 1e-6
    disp = np.random.default_rng(13).uniform(-4, 4, (3, 4, 2))
    before = warp2pass.launch_count
    out, calls = _recorded_k1_calls(lambda: dt.PiecewisePerspectiveTransform().find_and_warp(patches, disp))
    assert warp2pass.launch_count == before + 2 and len(calls) == 2
    assert out.img.device.type == "cuda" and out.img.shape == image.img.shape
    for data, cols, D in calls:
        assert 2 <= D <= 16
        assert torch.equal(warp2pass.warp_rows_t(data, cols, D), warp2pass.warp_rows_t_reference(data, cols, D))
    # The CPU takes the gather warp of the same spline: the two-pass warp's
    # own difference to exact bilinear on noise, bounded by the image range.
    on_cpu = dt.PiecewisePerspectiveTransform().find_and_warp(
        dt.Patches(dt.OpticalImage(frame, width=3.2, height=2.4, device="cpu"), [3, 4]), disp
    )
    assert (out.img.cpu() - on_cpu.img).abs().mean().item() <= 0.05


def test_colour_corrections_and_files_on_the_card(tmp_path):
    import darsia_tpu_torch as dt

    frame = _bench_like().astype(np.float32) / 255.0
    image = dt.OpticalImage(frame, width=3.2, height=2.4)
    relative = dt.RelativeColorCorrection(image, config={"degree": 1})
    rng = np.random.default_rng(14)
    relative.add_calibration_data(rng.random((30, 2)), rng.random((30, 3)), [0.5, 0.5, 0.5])
    relative.calibrate()
    relative.setup()
    assert relative._evaluated.device.type == "cuda"
    out = relative(image)
    relative_cpu = dt.RelativeColorCorrection(dt.OpticalImage(frame, width=3.2, height=2.4, device="cpu"))
    relative.save(tmp_path / "relative")
    relative_cpu.load(tmp_path / "relative.npz")
    on_cpu = relative_cpu.correct_array(torch.from_numpy(frame))
    assert out.img.device.type == "cuda" and (out.img.cpu() - on_cpu).abs().max().item() <= 1e-5

    ref = dt.ColorCheckerAfter2014().swatches_rgb
    checker = np.kron(ref, np.ones((40, 40, 1))).astype(np.float32) * np.array([0.9, 1.0, 0.8], np.float32)
    experimental = dt.ExperimentalColorCorrection()
    before = warp2pass.launch_count
    corrected = experimental(dt.OpticalImage(checker, width=2.4, height=1.6))
    assert warp2pass.launch_count == before + 2  # the checker crop's pair
    assert corrected.img.device.type == "cuda"
    flat = corrected.img.cpu().numpy()[5:-5, 5:-5]
    assert np.abs(flat - np.kron(ref, np.ones((40, 40, 1)))[5:-5, 5:-5]).mean() <= 0.02

    # Files: an image saved from the card comes back onto it.
    image.save(tmp_path / "image")
    back = dt.imread(tmp_path / "image.npz")
    assert back.img.device.type == "cuda" and torch.equal(back.img, image.img)
    assert dt.imread(tmp_path / "image.npz", device="cpu").img.device.type == "cpu"
    stacked = dt.stack([image, back])
    assert stacked.img.device.type == "cuda" and stacked.img.shape == (240, 320, 2, 3)
    assert dt.zeros_like(image, "voxels").img.device.type == "cuda"
    patchwise = dt.PatchwiseIlluminationCorrection(
        tmp_path / "image.npz", [tmp_path / "image.npz"], nw=16, limit=8
    )
    assert patchwise.correct_array(image.img).device.type == "cuda"


def test_dynamic_illumination_on_the_card_equals_the_cpu():
    """Set up on a card image and on its CPU copy: the same baseline colours
    (only the sample patches are read to the host), and a darker photograph
    rescaled on the card as on the CPU; the result stays on the card."""
    import darsia_tpu_torch as dt

    frame = _bench_like()
    samples = [(slice(20, 60), slice(30, 70)), (slice(150, 200), slice(200, 260))]
    on_card, on_cpu = dt.DynamicIlluminationCorrection(), dt.DynamicIlluminationCorrection()
    on_card.setup(dt.OpticalImage(frame).img, samples)
    on_cpu.setup(torch.from_numpy(frame), samples)
    assert np.abs(np.asarray(on_card.base_colors) - np.asarray(on_cpu.base_colors)).max() <= 1e-6
    probe = (frame * 0.7).astype(np.uint8)
    out = dt.OpticalImage(probe, transformations=[on_card])
    want = on_cpu.correct_array(torch.from_numpy(probe))
    assert out.img.device.type == "cuda"
    assert (out.img.cpu().to(torch.float32) - want.to(torch.float32)).abs().max().item() <= 1e-4


def test_deformation_correction_is_the_registration():
    import darsia_tpu_torch as dt

    rng = np.random.default_rng(15)
    base = torch.nn.functional.avg_pool2d(
        torch.from_numpy(rng.random((1, 3, 246, 326)).astype(np.float32)), 7, 1
    )[0].permute(1, 2, 0).contiguous().numpy()
    probe = np.roll(base, (1, 2), axis=(0, 1))
    meta = {"width": 3.2, "height": 2.4}
    base_img = dt.OpticalImage(base, **meta)
    config = {"N_patches": [2, 2], "rel_overlap": 0.2, "quality_tol": 0.01}
    deformation = dt.DeformationCorrection(base_img, config)
    before = warp2pass.launch_count
    out = dt.OpticalImage(probe, transformations=[deformation], **meta)
    assert warp2pass.launch_count == before + 2
    direct = dt.ImageRegistration(base_img, **config)(dt.OpticalImage(probe, **meta))
    assert out.img.device.type == "cuda" and torch.equal(out.img, direct.img)


# ------------------------------------------- restoration and the N-d core


def _blocks(shape, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.random(tuple(-(-n // 8) for n in shape))
    img = np.kron(coarse, np.ones((8,) * len(shape)))[tuple(slice(0, n) for n in shape)]
    return np.clip(img + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 128), (24, 32, 40)], ids=str)
def test_chambolle_on_the_card_matches_the_cpu(shape):
    """With its eps the card may stop an iteration apart from the CPU (the
    energy is a float32 reduction): 1e-4; a fixed count to 2e-5."""
    import darsia_tpu_torch as dt

    img = torch.from_numpy(_blocks(shape))
    for eps, cap, tol in ((2e-4, 200, 1e-4), (0.0, 15, 2e-5)):
        on_cpu = dt.chambolle_tvd(img, weight=0.15, eps=eps, max_num_iter=cap)
        on_card = dt.chambolle_tvd(img.cuda(), weight=0.15, eps=eps, max_num_iter=cap)
        assert on_card.is_cuda and (on_card.cpu() - on_cpu).abs().max().item() <= tol


@pytest.mark.parametrize("solver", ["Jacobi", "CG", "MG"])
@pytest.mark.parametrize("isotropic", [False, True], ids=["anisotropic", "isotropic"])
def test_split_bregman_on_the_card_matches_the_cpu(isotropic, solver):
    """Fixed count (``eps=None``): 2e-5 on a unit-range image; numpy input
    goes to the card by default."""
    import darsia_tpu_torch as dt

    img = _blocks((96, 128), seed=1)
    omega = (0.5 + np.random.default_rng(2).random((96, 128))).astype(np.float32)
    make = {
        "Jacobi": lambda: dt.Jacobi(maxiter=10),
        "CG": lambda: dt.CG(maxiter=10),
        "MG": lambda: dt.MG(maxiter=1, depth=2),
    }[solver]
    kw = {"mu": 0.3, "omega": omega, "max_num_iter": 8, "isotropic": isotropic}
    on_cpu = dt.split_bregman_tvd(img, solver=make(), device="cpu", **kw)
    on_card = dt.split_bregman_tvd(img, solver=make(), **kw)
    assert on_card.is_cuda and (on_card.cpu() - on_cpu).abs().max().item() <= 2e-5
    volume = _blocks((24, 32, 40), seed=3)
    on_cpu = dt.split_bregman_tvd(volume, mu=0.3, dim=3, max_num_iter=4, solver=make(), device="cpu")
    on_card = dt.split_bregman_tvd(volume, mu=0.3, dim=3, max_num_iter=4, solver=make())
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 2e-5


def test_volume_slices_and_integral_on_the_card():
    import darsia_tpu_torch as dt

    data = _blocks((24, 32, 40), seed=4)
    volume = dt.ScalarImage(data, space_dim=3, dimensions=[0.24, 0.32, 0.4])
    assert volume.img.is_cuda
    cs = volume.coordinatesystem
    for axis, matrix_axis in (("x", 1), ("y", 2), ("z", 0)):
        voxel = np.zeros(3)
        voxel[matrix_axis] = 7.5
        cut = float(np.asarray(cs.coordinate(voxel))["xyz".find(axis)])
        plane = volume.slice(cut, axis)
        assert plane.img.is_cuda and plane.space_dim == 2
        assert np.array_equal(plane.img.cpu().numpy(), np.take(data, 7, axis=matrix_axis))
    exact = data.astype(np.float64).sum() * 1e-6
    assert abs(volume.integral() - exact) <= 1e-6 * exact
    assert np.array_equal(volume.eval(dt.make_voxel([[3, 4, 5]])), data[3:4, 4, 5])
    assert dt.median_filter(data[0], 2).is_cuda


def test_geometry_integrates_numpy_and_fits_its_weights_on_the_card(monkeypatch):
    """Numpy data goes to the card by default, and the weight map is fitted
    to data of another shape there: no tensor of the way lies on the CPU."""
    import darsia_tpu_torch as dt

    data = _blocks((96, 128), seed=5)
    weight = (0.2 + np.random.default_rng(6).random((96, 128))).astype(np.float32)
    image = dt.ScalarImage(data, dimensions=[0.96, 1.28])
    geometry = dt.WeightedGeometry(weight, **image.shape_metadata())
    exact = (data.astype(np.float64) * weight).sum() * 1e-4
    half = dt.resize(image, shape=(48, 64))
    made = []
    for name in ("to", "cpu"):
        original = getattr(torch.Tensor, name)

        def record(self, *args, _original=original, **kwargs):
            out = _original(self, *args, **kwargs)
            made.append((self.device.type, out.device.type, out.dim()))
            return out

        monkeypatch.setattr(torch.Tensor, name, record)
    total = geometry.integrate(data)
    coarse = geometry.integrate(half)
    monkeypatch.undo()
    assert abs(total - exact) <= 1e-6 * exact and abs(coarse - exact) <= 1e-2 * exact
    # Host arrays go up to the card; what comes down is the resized weight
    # map (kept on the host, as all voxel volumes are) and nothing else.
    assert ("cpu", "cuda", 2) in made
    assert [m for m in made if m[1] == "cpu" and m[0] == "cpu"] == []
    mg = dt.MG(mass_coeff=weight, diffusion_coeff=0.5, maxiter=1)
    mg.restrict_parameters()
    assert isinstance(mg.mass_coeff, np.ndarray)
    assert mg(half.img, half.img).is_cuda


def _colour_to_mass_chain(device, H=96, W=128, seed=21):
    """(chain, image, geometry) of a 3-label scene on ``device``: seeded
    4-segment relative colour paths, a plume painted along each, noise."""
    import darsia_tpu_torch as dt

    rng = np.random.default_rng(seed)
    labels = (np.arange(H)[:, None] * 3 // H + np.zeros((1, W), int)).astype(np.int64)
    base = (0.3 + 0.4 * rng.random((H, W, 3))).astype(np.float32)
    img = base.copy()
    meta = {"width": 1.28, "height": 0.96}
    interps, functions = {}, {}
    for label in range(3):
        steps = rng.uniform(0.02, 0.08, (4, 3)) * np.array([1.0, -0.5, 0.3])
        path = dt.ColorPath(relative_colors=list(np.cumsum(np.vstack([np.zeros(3), steps]), axis=0)), base_color=np.zeros(3))
        interps[label] = dt.ColorPathInterpolation(path, dt.ColorMode.RELATIVE, values=path.equidistant_distances)
        functions[label] = dt.PWTransformation([0.0, 0.4 + 0.1 * label, 1.0], [0.0, 0.3, 1.0])
        rows = labels[:, 0] == label
        params = rng.uniform(0.05, 0.95, (int(rows.sum()), W // 2))
        img[rows, : W // 2] += path.interpret(params, dt.ColorMode.RELATIVE, mode="equidistant").astype(np.float32)
    img += (rng.standard_normal(img.shape) * 0.01).astype(np.float32)
    baseline = dt.OpticalImage(torch.from_numpy(base).to(device), **meta)
    geometry = dt.ExtrudedPorousGeometry(np.full((H, W), 0.44), np.full((H, W), 0.019), **baseline.shape_metadata())
    chain = dt.HeterogeneousColorToMassAnalysis(
        baseline,
        dt.Image(torch.from_numpy(labels).to(device), scalar=True, **meta),
        dt.ColorMode.RELATIVE,
        interps,
        functions,
        dt.SimpleFlash(0.05, 0.5, 0.5, 1.0),
        dt.CO2MassAnalysis(baseline, 1.01, 23.0),
        geometry,
        expert_knowledge_adapter=dt.ExpertKnowledgeAdapter(
            saturation_g_rois={"gas": np.array([[0.1, 0.9], [0.6, 0.4]])}
        ),
    )
    return chain, dt.OpticalImage(torch.from_numpy(img).to(device), **meta), geometry


def test_colour_to_mass_chain_on_the_card_matches_the_cpu(monkeypatch):
    """The chain on the card against the same chain on CPU tensors: every
    output within 1e-5 (mass maps relative to their largest value) but where
    ``fit`` ties (two segments within 1e-6 of equally close with different
    parameters); after the first call nothing full-size leaves the card and
    nothing is copied to it."""
    (card, image, geometry), (cpu, cpu_image, cpu_geometry) = (
        _colour_to_mass_chain(device) for device in ("cuda", "cpu")
    )
    geometry.integrate(card(image).mass)  # uploads the constants once
    made = []
    for name in ("cpu", "numpy", "item", "to"):
        original = getattr(torch.Tensor, name)

        def record(self, *args, _original=original, _name=name, **kwargs):
            out = _original(self, *args, **kwargs)
            moved = isinstance(out, torch.Tensor) and out.device != self.device
            made.append((_name, self.dim(), moved))
            return out

        monkeypatch.setattr(torch.Tensor, name, record)
    result = card(image)
    mass = geometry.integrate(result.mass)
    monkeypatch.undo()
    assert [m for m in made if m[0] in ("cpu", "numpy") or m[2] or (m[0] == "item" and m[1])] == []
    want = cpu(cpu_image)
    ties = torch.zeros(image.img.shape[:2], dtype=torch.bool)
    labels = card.labels.img.cpu()
    diff = (image.img - card.color_analysis.base.img).cpu()
    for label, interp in card.color_path_interpretation.items():
        params, l1 = interp.color_path.fit_terms(diff, interp.color_mode, "equidistant")
        near = l1 <= l1.min(dim=-1, keepdim=True).values + 1e-6
        spread = torch.where(near, params, -torch.inf).amax(-1) - torch.where(near, params, torch.inf).amin(-1)
        ties |= (labels == label) & (spread > 1e-6)
    assert int(ties.sum()) <= 2
    keep = ~ties
    for key in ("saturation_g", "concentration_aq", "mass", "mass_g", "mass_aq"):
        got, ref = getattr(result, key).img.cpu(), getattr(want, key).img
        scale = 1.0 if key in ("saturation_g", "concentration_aq") else float(ref.abs().max())
        assert float((got - ref)[keep].abs().max()) <= 1e-5 * scale, key
    assert torch.isfinite(result.mass.img).all() and mass > 0
    assert abs(mass - cpu_geometry.integrate(want.mass)) <= 1e-5 * mass


def test_newton_w1_on_the_card_matches_the_cpu():
    """The weighted block problem of bench.py's W1 row at 32 x 32, Newton with
    AA(5): the solve on the card (images and weight built from numpy) against
    the same solve on CPU tensors."""
    import darsia_tpu_torch as dt

    n, q = 32, 3
    src = np.zeros((n, n), np.float32)
    dst = np.zeros((n, n), np.float32)
    src[2 * q : 5 * q, 2 * q : 5 * q] = 1.0
    dst[q : 3 * q, q : 2 * q] = 1.0
    dst[4 * q : 7 * q, 7 * q : 9 * q] = 1.0
    src /= src.sum() / n**2
    dst /= dst.sum() / n**2
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    weight = (2.0 + np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy)).astype(np.float32)
    options = {"num_iter": 500, "L": 1e9, "tol_increment": 1e-4, "tol_distance": 1e-4,
               "aa_depth": 5, "return_info": True}
    meta = {"width": 1, "height": 1, "scalar": True}
    out = {}
    for device in (None, "cpu"):
        a, b = dt.Image(src, device=device, **meta), dt.Image(dst, device=device, **meta)
        out[device] = dt.wasserstein_distance(a, b, method="newton", weight=weight, options=options)
    (d_card, info_card), (d_cpu, info_cpu) = out[None], out["cpu"]
    assert info_card["pressure"].device.type == "cuda"
    assert info_card["converged"] and info_cpu["converged"]
    assert abs(d_card - d_cpu) <= 1e-5 * d_cpu


def test_batched_w1_on_the_card_matches_single_solves_and_the_cpu():
    """``batched_wasserstein`` on the card (a numpy batch goes there): each
    pair against its single Newton solve on the card, and the batch against
    the same batch as CPU tensors, within 1e-5 relative."""
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.parallel import batched_wasserstein

    n, B, q = 32, 3, 3
    rng = np.random.default_rng(0)
    src0 = np.zeros((n, n))
    src0[2 * q : 5 * q, 2 * q : 5 * q] = 1
    dst0 = np.zeros((n, n))
    dst0[q : 3 * q, q : 2 * q] = 1
    dst0[4 * q : 7 * q, 7 * q : 9 * q] = 1
    src = np.stack([src0 + 0.02 * rng.random((n, n)) for _ in range(B)])
    dst = np.stack([dst0 + 0.02 * rng.random((n, n)) for _ in range(B)])
    src = (src / src.sum(axis=(1, 2), keepdims=True) * n * n).astype(np.float32)
    dst = (dst / dst.sum(axis=(1, 2), keepdims=True) * n * n).astype(np.float32)
    options = {"num_iter": 100, "tol_distance": 1e-4}
    solve = batched_wasserstein((n, n), 1.0 / n, None, options)
    card = solve(src, dst)
    cpu = solve(torch.from_numpy(src), torch.from_numpy(dst))
    assert np.all(card[2] == 1) and np.array_equal(card[2], cpu[2])
    assert np.all(np.abs(card[0] - cpu[0]) <= 1e-5 * cpu[0])
    for i in range(B):
        solver = dt.BeckmannNewtonSolver(dt.Grid((n, n), 1.0 / n), None, options)
        distance, _, pressure, info = solver.solve_beckmann_problem(
            torch.from_numpy(dst[i] - src[i]).cuda()
        )
        assert pressure.device.type == "cuda" and info["converged"]
        assert abs(card[0][i] - distance) <= 1e-5 * distance


def test_label_histograms_on_the_card_equal_numpy():
    """Per-label histograms of values on the bin edges, on the card, against
    ``np.histogram`` of each label's values."""
    from darsia_tpu_torch.signals.models.dynamicthresholdmodel import label_histograms

    rng = np.random.default_rng(0)
    edges = np.linspace(0.1, 0.9, 257)
    values = np.concatenate(
        [edges[rng.integers(0, 257, 20000)], rng.uniform(0.1, 0.9, 20000)]
    ).astype(np.float32)
    groups = rng.integers(-1, 5, values.shape)
    counts, got_edges, sizes = label_histograms(
        torch.from_numpy(values).cuda(), torch.from_numpy(groups).cuda(), 5
    )
    for g in range(5):
        ref_counts, ref_edges = np.histogram(values[groups == g].astype(np.float64), bins=256)
        np.testing.assert_array_equal(counts[g], ref_counts)
        np.testing.assert_array_equal(got_edges[g], ref_edges)
        assert sizes[g] == (groups == g).sum()


def test_threshold_models_on_the_card_match_the_cpu():
    """Static per-label thresholds (the gathered bounds), dynamic Otsu per
    label, and the per-label linear model: card == CPU, bitwise."""
    import darsia_tpu_torch as dt

    rng = np.random.default_rng(1)
    labels = np.sort(rng.integers(0, 6, (300, 400)), axis=0)
    signal = rng.uniform(0, 1, (300, 400)).astype(np.float32)
    static = dt.StaticThresholdModel(list(np.linspace(0.2, 0.7, 6)), [0.9] * 6, labels=labels)
    dynamic = dt.ThresholdModel(labels, key="x ", **{"x threshold dynamic": True})
    linear = dt.HeterogeneousLinearModel(labels, scaling=list(np.linspace(0.5, 2.0, 6)), offset=0.1)
    for model in (static, dynamic, linear):
        card = model(torch.from_numpy(signal).cuda()).cpu()
        cpu = model(torch.from_numpy(signal))
        assert torch.equal(card, cpu)


def test_analysis_base_reads_onto_the_card(tmp_path):
    """A manager given no device reads the baseline and each photograph onto
    the card."""
    import json

    import darsia_tpu_torch as dt

    rng = np.random.default_rng(2)
    dt.OpticalImage(rng.random((40, 60, 3)).astype(np.float32), width=2.0, height=1.0).save(
        tmp_path / "base.npz"
    )
    config = {
        "physical_asset": {"dimensions": {"width": 2.0, "height": 1.0}},
        "curvature": {"bulge": {"vertical_bulge": -1e-6}},
    }
    (tmp_path / "config.json").write_text(json.dumps(config))
    analysis = dt.AnalysisBase(tmp_path / "base.npz", tmp_path / "config.json")
    assert analysis.base.img.is_cuda
    assert analysis.load_and_process_image(tmp_path / "base.npz").img.is_cuda


def test_kernel_launches_from_threads_count_exactly():
    """K1 launched from 8 threads at once (the analysis loader's workers):
    every launch counted, every result bitwise equal to the plain version."""
    import threading

    cases = [_rows_case(3, 64, 300, 7, seed=s) for s in range(8)]
    per_thread = 25
    results = {}
    barrier = threading.Barrier(len(cases))

    def launch(k):
        data, cols = cases[k]
        barrier.wait()
        for _ in range(per_thread):
            results[k] = warp2pass.warp_rows_t(data, cols, 7)

    before = warp2pass.launch_count
    threads = [threading.Thread(target=launch, args=(k,)) for k in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + len(cases) * per_thread
    for k, (data, cols) in enumerate(cases):
        assert torch.equal(results[k], warp2pass.warp_rows_t_reference(data, cols, 7))


def test_skeleton_on_the_card_equals_the_host_skeleton():
    """The skeleton as boolean tensor ops on the card (``ops/morphology.py``)
    bitwise equal to the host ``utils/morphology.py::skeletonize`` at a
    ragged 4K shape (seeded blobs up to ~40 px thick, a hole, the border
    touched), with the same number of erosions; the endpoint and
    branch-point counts of ``SkeletonAnalysis`` on the card equal scipy's."""
    from scipy import ndimage

    from darsia_tpu_torch.analysis.skeleton_analysis import SkeletonAnalysis
    from darsia_tpu_torch.ops.morphology import skeletonize
    from darsia_tpu_torch.utils.morphology import skeletonize as host_skeletonize

    rng = np.random.default_rng(15)
    mask = rng.random((1787, 3181)) > 0.9995
    mask = ndimage.binary_dilation(mask, structure=np.ones((3, 3), bool), iterations=16)
    mask[:40, :700] = True
    mask[900:960, 1200:1260] = False
    got, iterations = skeletonize(torch.from_numpy(mask).cuda())
    want = host_skeletonize(mask)
    assert np.array_equal(got.cpu().numpy(), want)
    eroded, count = mask, 0
    while eroded.any():
        eroded = ndimage.binary_erosion(eroded, structure=ndimage.generate_binary_structure(2, 1))
        count += 1
    assert iterations == count > 10
    analysis = SkeletonAnalysis()
    analysis.load(mask)
    assert analysis.skeleton_mask.is_cuda
    neighbours = ndimage.convolve(want.astype(np.int32), np.ones((3, 3), np.int32), mode="constant")
    assert np.array_equal(analysis.endpoints(), np.argwhere(want & (neighbours == 2)))
    assert np.array_equal(analysis.branch_points(), np.argwhere(want & (neighbours >= 4)))


def test_features_on_the_card_equal_the_cpu(monkeypatch):
    """``FeatureDetection.extract_features`` of an image on the card masks
    it and computes the Harris response there, and gives the keypoints and
    descriptors of the same image on the CPU, at a ragged 4K shape."""
    from darsia_tpu_torch.utils import features

    # Seeded so that the 201 strongest maxima differ by more than 2e-5
    # relative: no near-ties for float rounding to reorder.
    rng = np.random.default_rng(18)
    gray = np.zeros((1787, 3181), np.float32)
    for _ in range(300):
        r, c = rng.integers(8, 1700), rng.integers(8, 3100)
        gray[r : r + rng.integers(10, 60), c : c + rng.integers(10, 60)] += rng.uniform(0.3, 1)
    gray += rng.normal(0, 0.01, gray.shape).astype(np.float32)
    rgb = np.stack([gray, 0.5 * gray, 0.2 * gray], axis=-1)
    mask = np.ones(gray.shape, bool)
    mask[:200] = False
    roi = (slice(4, 1780), slice(3, 3170))

    devices = []
    response = features._harris_response

    def spy(gray, k=0.05, device=None):
        devices.append(gray.device.type)
        return response(gray, k, device)

    monkeypatch.setattr(features, "_harris_response", spy)
    kp_gpu, desc_gpu = features.FeatureDetection.extract_features(
        torch.from_numpy(rgb).cuda(), roi=roi, mask=mask
    )
    kp_cpu, desc_cpu = features.FeatureDetection.extract_features(torch.from_numpy(rgb), roi=roi, mask=mask)
    assert devices == ["cuda", "cpu"]
    assert len(kp_cpu) == 200
    np.testing.assert_array_equal(kp_gpu, kp_cpu)
    assert np.abs(desc_gpu - desc_cpu).max() <= 1e-6


def _photo_u8(h=120, w=200, seed=5):
    rng = np.random.default_rng(seed)
    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    arr[20:40, 30:60] = [255, 0, 255]
    return arr


def test_encode_of_a_card_image_equals_the_cpu_image():
    import darsia_tpu_torch as dt

    arr = _photo_u8()
    card = dt.OpticalImage(arr, width=2.0, height=1.2)
    host = dt.OpticalImage(torch.from_numpy(arr), width=2.0, height=1.2)
    assert card.img.device.type == "cuda"
    for suffix, kw in ((".png", {}), (".jpg", {"quality": 95}), (".tif", {})):
        assert card.encode(suffix, **kw) == host.encode(suffix, **kw)
    scalar = dt.ScalarImage(arr[..., 0].astype(np.float32) / 255)
    assert scalar.img.device.type == "cuda"


def test_detect_color_on_the_card_equals_the_cpu():
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.utils.detection import detect_color

    arr = _photo_u8()
    card = detect_color(dt.OpticalImage(arr), [255, 0, 255], tolerance=5e-2)
    host = detect_color(dt.OpticalImage(torch.from_numpy(arr)), [255, 0, 255], tolerance=5e-2)
    assert len(card) == 20 * 30 and np.array_equal(np.asarray(card), np.asarray(host))


def test_imread_of_a_jpeg_lands_on_the_card(tmp_path):
    import cv2

    import darsia_tpu_torch as dt

    arr = _photo_u8()
    cv2.imwrite(str(tmp_path / "photo.jpg"), arr[..., ::-1].copy(), [cv2.IMWRITE_JPEG_QUALITY, 95])
    img = dt.imread(tmp_path / "photo.jpg")
    assert img.img.device == torch.device("cuda", 0) and img.img.dtype == torch.uint8
    host = dt.imread(tmp_path / "photo.jpg", device="cpu")
    assert torch.equal(img.img.cpu(), host.img)
    yuv = dt.imread(tmp_path / "photo.jpg", transfer="yuv420")
    assert yuv.img.device == torch.device("cuda", 0)
    # The bilinear upsample may round differently on the card: within
    # tests/test_torch_transfer.py's bound.
    diff = (yuv.img.cpu().int() - dt.imread(tmp_path / "photo.jpg", device="cpu", transfer="yuv420").img.int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3


def test_halo_exchange_2d_on_a_card_mesh_equals_the_edge_pad():
    """A (2, 2) mesh naming cuda:0 four times: each extended tile is the
    slice of the edge-padded global image, bitwise."""
    from darsia_tpu_torch.parallel import Placement, create_mesh, halo_exchange_2d

    mesh = create_mesh((2, 2), ("rows", "cols"), devices=["cuda:0"] * 4)
    x = torch.from_numpy(np.random.default_rng(5).random((64, 96)).astype(np.float32)).cuda()
    halo = 3
    out = halo_exchange_2d(Placement(mesh, ("rows", "cols")).split(x), halo)
    padded = torch.nn.functional.pad(x[None, None], (halo,) * 4, mode="replicate")[0, 0]
    for i in range(2):
        for j in range(2):
            assert out[i][j].device == torch.device("cuda", 0)
            block = padded[i * 32 : i * 32 + 32 + 2 * halo, j * 48 : j * 48 + 48 + 2 * halo]
            assert torch.equal(out[i][j], block)


def test_sharded_warp_on_a_card_mesh_matches_the_gather_warp():
    """sharded_warp over cuda:0 x 4 == the single-device gather warp on the
    card within 1e-5 (tile-local bilinear weights), K1 not launched."""
    from darsia_tpu_torch.ops.warp import identity_grid, warp
    from darsia_tpu_torch.parallel import create_mesh, sharded_warp

    H, W, D = 128, 192, 6
    rng = np.random.default_rng(13)
    img = torch.from_numpy(rng.random((H, W, 3)).astype(np.float32)).cuda()
    yy, xx = np.meshgrid(np.linspace(0, np.pi, H), np.linspace(0, np.pi, W), indexing="ij")
    disp = np.stack([D * 0.9 * np.sin(2 * xx), -D * 0.9 * np.cos(yy)]).astype(np.float32)
    coords = identity_grid((H, W), "cuda") + torch.from_numpy(disp).cuda()
    mesh = create_mesh((2, 2), ("rows", "cols"), devices=["cuda:0"] * 4)
    before = warp2pass.launch_count
    out = sharded_warp(mesh, (H, W), max_disp=D)(img, coords)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before
    assert out.device == torch.device("cuda", 0)
    assert (out - warp(img, coords, order=1)).abs().max().item() <= 1e-5


def test_numpy_assigned_to_a_card_image_lands_on_the_card():
    import darsia_tpu_torch as dt

    rng = np.random.default_rng(19)
    image = dt.ScalarImage(torch.zeros((48, 64), device="cuda:0"), width=1.6, height=1.2)
    host = rng.random((48, 64)).astype(np.float32)
    image.img = host
    assert image.img.device == torch.device("cuda:0")
    assert torch.equal(image.img.cpu(), torch.from_numpy(host))
    copied = image.copy()
    resized = dt.resize(image, shape=(24, 32), interpolation="inter_nearest")
    assert copied.img.device.type == resized.img.device.type == "cuda"
    on_cpu = dt.ScalarImage(torch.from_numpy(host), width=1.6, height=1.2)
    cpu_resized = dt.resize(on_cpu, shape=(24, 32), interpolation="inter_nearest")
    assert torch.equal(resized.img.cpu(), cpu_resized.img)
    integral = float(dt.Geometry(**image.shape_metadata()).integrate(image))
    want = float(host.astype(np.float64).sum()) * (1.6 / 64) * (1.2 / 48)
    assert abs(integral - want) <= 1e-6 * abs(want)
    moved = dt.ScalarImage(torch.from_numpy(host), width=1.6, height=1.2, device="cuda:0")
    assert moved.img.device == torch.device("cuda:0")


def test_build_fused_aligner_launches_k1_twice_per_call():
    import darsia_tpu_torch as dt

    rng = np.random.default_rng(23)
    base = torch.from_numpy(rng.random((192, 256, 3)).astype(np.float32)).cuda()
    base = torch.nn.functional.avg_pool2d(base.permute(2, 0, 1)[None], 5, 1, 2)[0].permute(1, 2, 0).contiguous()
    probe = torch.roll(base, shifts=(2, -3), dims=(0, 1))
    ta = dt.TranslationAnalysis(dt.OpticalImage(base, width=1.0, height=0.75), N_patches=[3, 4], rel_overlap=0.2)
    aligner = ta.build_fused_aligner(max_disp=40)
    before = warp2pass.launch_count
    out, shifts, quality = aligner(probe)
    torch.cuda.synchronize()
    assert warp2pass.launch_count == before + 2
    aligned = ta.fused_align(dt.OpticalImage(probe, width=1.0, height=0.75), max_disp=40)
    assert torch.equal(aligned.img, out) and warp2pass.launch_count == before + 4
    assert out.is_cuda and bool(torch.isfinite(out).all()) and shifts.shape == (12, 2)
