"""The port's ``SimpleFluidFlower`` against the JAX package.

Set-up, read, save and load as ``tests/unit/test_fluidflower_presets.py``
drives them (type and resize corrections), then the default chain (type,
drift on the checker, curvature from a config, colour on the checker) on a
seeded 240x400 frame with a painted 4x6 checker and a photograph drifted
by (2, 3) px: the chains hold the same corrections, the reads agree within
1e-5 (float32 colour pipelines of both packages) and are float32 in both,
and the data that the fused drift + curvature warp receives is float32 in
both (the JAX package asks for float64 but runs without 64-bit floats; K1
takes float32 only).  A saved and loaded rig reads bitwise as before.  A
failed colour set-up warns and leaves the colour correction out in both;
``setup_curvature_correction`` on a JPEG ROI photograph with four painted
marks finds the same corners as the JAX package (the crop assistant, item
7d).  The port runs on the CPU (``device="cpu"``).
"""

import warnings

import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

torch.set_num_threads(1)

H, W = 240, 400
SWATCH = 16
#: Reads through both packages' float32 colour pipelines.
READ_TOL = 1e-5


def _curvature(h=H, w=W) -> dict:
    return {
        "crop": {"pts_src": [[3, 4], [h - 4, 3], [h - 3, w - 5], [4, w - 3]], "width": 0.92, "height": 0.55},
        "bulge": {"horizontal_bulge": 1e-6, "vertical_bulge": 2e-6},
    }


def _frame(seed: int = 0, checker: bool = True) -> np.ndarray:
    frame = (np.random.default_rng(seed).random((H, W, 3)) * 255).astype(np.uint8)
    if checker:
        ref = da.ColorCheckerAfter2014().swatches_rgb
        r0, c0 = 12, W - 12 - 6 * SWATCH
        patch = np.kron(ref, np.ones((SWATCH, SWATCH, 1))) * 255
        frame[r0 : r0 + 4 * SWATCH, c0 : c0 + 6 * SWATCH] = patch.astype(np.uint8)
    return frame


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("simplefluidflower")
    frame = _frame()
    da.OpticalImage(frame, width=0.92, height=0.55).save(root / "base.npz")
    da.OpticalImage(np.roll(frame, (2, 3), axis=(0, 1)), width=0.92, height=0.55).save(root / "probe.npz")
    da.OpticalImage(_frame(1, checker=False), width=0.92, height=0.55).save(root / "plain.npz")
    return root


def _pair(files, active=None, **setup):
    kwargs = {} if active is None else {"active_corrections": active}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = da.SimpleFluidFlower(files / "base.npz", **kwargs)
        ref.setup(specs={"width": 0.92, "height": 0.55}, **setup)
        port = dt.SimpleFluidFlower(files / "base.npz", device="cpu", **kwargs)
        port.setup(specs={"width": 0.92, "height": 0.55}, **setup)
    return port, ref


def test_setup_read_save_load(files, tmp_path):
    """tests/unit/test_fluidflower_presets.py:130-151, both packages."""
    port, ref = _pair(files, ["type", "resize"])
    assert [type(c).__name__ for c in port.corrections] == [type(c).__name__ for c in ref.corrections] == [
        "TypeCorrection",
        "Resize",
    ]
    img = port.read_image(files / "base.npz")
    want = np.asarray(ref.read_image(files / "base.npz").img)
    assert tuple(img.img.shape) == want.shape == (H, W, 3)
    assert img.img.device.type == "cpu" and img.img.dtype == torch.float32
    assert np.abs(img.img.numpy() - want).max() <= READ_TOL
    port.save(tmp_path / "rig")
    loaded = dt.SimpleFluidFlower(files / "base.npz", active_corrections=["type", "resize"], device="cpu")
    loaded.load(tmp_path / "rig")
    assert loaded.width == 0.92 and loaded.porosity == 0.44 and len(loaded.corrections) == 2
    assert torch.equal(loaded.read_image(files / "base.npz").img, img.img)
    # A rig the JAX package saved.
    ref.save(tmp_path / "jax_rig")
    from_jax = dt.SimpleFluidFlower(files / "base.npz", active_corrections=["type", "resize"], device="cpu")
    from_jax.load(tmp_path / "jax_rig")
    assert [type(c).__name__ for c in from_jax.corrections] == ["TypeCorrection", "Resize"]


@pytest.fixture(scope="module")
def default_chain(files):
    return _pair(files, curvature_options={"config": _curvature()})


def test_default_chain_matches_jax(default_chain, files):
    port, ref = default_chain
    names = [type(c).__name__ for c in port.corrections]
    assert names == [type(c).__name__ for c in ref.corrections]
    assert names == ["TypeCorrection", "DriftCorrection", "CurvatureCorrection", "ColorCorrection"]
    np.testing.assert_array_equal(np.asarray(port.drift_config["roi"]), np.asarray(ref.drift_config["roi"]))
    got = port.read_image(files / "probe.npz")
    want = np.asarray(ref.read_image(files / "probe.npz").img)
    assert got.img.dtype == torch.float32 and want.dtype == np.float32
    assert got.img.shape == want.shape
    assert np.abs(got.img.numpy() - want).max() <= READ_TOL
    # The set-up corrects the baseline step by step: its drift against
    # itself is a shift of order 1e-8 px whose sign float rounding decides,
    # and a sample that falls that far outside the frame is 0 (in both
    # packages).  So the pixels the curvature warp draws from within 1 px of
    # the frame's border may differ; every other pixel agrees.
    grid, _ = port.curvature_correction.pullback_field((H, W), "cpu")
    border = (grid[0] < 1) | (grid[0] > H - 2) | (grid[1] < 1) | (grid[1] > W - 2)
    diff = np.abs(port.baseline.img.numpy() - np.asarray(ref.baseline.img)).max(axis=-1)
    assert diff[~border.numpy()].max() <= READ_TOL
    assert border.float().mean() < 0.1


def test_the_warp_receives_float32_in_both(default_chain, files, monkeypatch):
    import darsia_tpu.corrections.fuse as jax_fuse
    import darsia_tpu_torch.corrections.fuse as port_fuse

    seen = {}
    for name, module in (("jax", jax_fuse), ("port", port_fuse)):
        inner = module.warp_backend

        def recording(img, *args, _inner=inner, _name=name, **kwargs):
            seen.setdefault(_name, []).append(str(img.dtype))
            return _inner(img, *args, **kwargs)

        monkeypatch.setattr(module, "warp_backend", recording)
    port, ref = default_chain
    port.read_image(files / "probe.npz")
    # The JAX chain is traced once per shape: trace it again.
    import jax

    jax.clear_caches()
    ref.read_image(files / "probe.npz")
    assert seen["jax"] == ["float32"] and seen["port"] == ["torch.float32"]
    assert port.type_conversion.data_type == np.float32


def test_save_load_reads_bitwise(default_chain, files, tmp_path):
    port, _ = default_chain
    before = port.read_image(files / "probe.npz").img
    port.save(tmp_path / "rig")
    loaded = dt.SimpleFluidFlower(files / "base.npz", device="cpu")
    loaded.load(tmp_path / "rig")
    assert [type(c).__name__ for c in loaded.corrections] == [type(c).__name__ for c in port.corrections]
    assert torch.equal(loaded.read_image(files / "probe.npz").img, before)
    assert torch.equal(loaded.baseline.img, port.baseline.img)


def test_failed_colour_setup_warns_in_both(files):
    for pkg in (da, dt):
        kwargs = {"device": "cpu"} if pkg is dt else {}
        rig = pkg.SimpleFluidFlower(files / "plain.npz", active_corrections=["type", "color"], **kwargs)
        with pytest.warns(UserWarning, match="Color correction not set up"):
            rig.setup(specs={})
        assert [type(c).__name__ for c in rig.corrections] == ["TypeCorrection"]


def test_curvature_from_roi_names_item_7d(files, tmp_path):
    """Item 7d's crop assistant: marks painted on a JPEG ROI photograph give
    the JAX package's corners, within 1 px of the painted ones, and the same
    corrected read."""
    import cv2

    roi = np.full((H, W, 3), 120, np.uint8)
    painted = [(16, 16), (H - 17, 16), (H - 17, W - 17), (16, W - 17)]  # TL, BL, BR, TR
    for r, c in painted:
        # 16-px blocks aligned to the JPEG's MCUs decode exactly.
        r0, c0 = r - r % 16, c - c % 16
        roi[r0 : r0 + 16, c0 : c0 + 16] = 255
    cv2.imwrite(str(tmp_path / "roi.jpg"), roi, [cv2.IMWRITE_JPEG_QUALITY, 95])
    rigs = []
    for pkg, kw in ((dt, {"device": "cpu"}), (da, {})):
        rig = pkg.SimpleFluidFlower(files / "base.npz", active_corrections=["type"], **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rig.setup(specs={"width": 0.92, "height": 0.55})
        rig.setup_curvature_correction(tmp_path / "roi.jpg", roi_color=[255, 255, 255])
        rigs.append(rig)
    port, ref = rigs
    got = np.asarray(port.curvature_config["crop"]["pts_src"])
    assert np.array_equal(got, np.asarray(ref.curvature_config["crop"]["pts_src"]))
    assert np.abs(got - np.asarray(painted)).max() <= 1
    out = port.curvature_correction(port.baseline).img.numpy()
    want = np.asarray(ref.curvature_correction(ref.baseline).img)
    assert out.shape == want.shape and np.abs(out.astype(float) - want.astype(float)).max() <= 1
    with pytest.raises(ValueError, match="roi_color"):
        port.setup_curvature_correction(tmp_path / "roi.jpg")
    curved = dt.SimpleFluidFlower(files / "base.npz", active_corrections=["curvature"], device="cpu")
    with pytest.raises(ValueError, match="curvature_options"):
        curved.setup(specs={})


def test_activate_corrections_and_water_height(default_chain, files):
    port, ref = default_chain
    for rig in (port, ref):
        rig.activate_corrections(["type", "curvature"])
    assert [type(c).__name__ for c in port.corrections] == ["TypeCorrection", "CurvatureCorrection"]
    assert np.abs(port.baseline.img.numpy() - np.asarray(ref.baseline.img)).max() <= READ_TOL
    cut = port.restrict_to_water_height(port.baseline)
    assert tuple(cut.img.shape) == np.asarray(ref.restrict_to_water_height(ref.baseline).img).shape
    for rig in (port, ref):
        rig.activate_corrections(["type", "drift", "curvature", "color"])
