"""The port's assistants against the JAX package's.

Mirrors ``tests/unit/test_assistants.py`` with both packages on the same
seeded image (the port's on the CPU): the programmatic selections
(points, boxes, rectangles, subregions, a rotation), the crop assistant's
marks found from colour (on an array and on a JPEG photograph), the label
assistants (segment, merge, pick, mask selection, a masked re-segmentation)
and the monochromatic view give equal results: bitwise for selections and
labels, 1e-6 for float images.  The interactive loop runs under
matplotlib's Agg backend with synthetic events (clicks, ``d``, ``escape``,
``enter``), and a strict assistant without a display raises; without
matplotlib it names it.
"""

import sys

import matplotlib
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt

matplotlib.use("Agg")
torch.set_num_threads(1)

FLOAT_TOL = 1e-6


def _array():
    rng = np.random.default_rng(0)
    return rng.uniform(0.3, 0.6, (60, 90, 3)).astype(np.float32)


@pytest.fixture
def pair():
    arr = _array()
    meta = {"width": 1.8, "height": 1.2, "color_space": "RGB"}
    return dt.Image(torch.from_numpy(arr), **meta), da.Image(arr, **meta)


def test_point_box_rectangle_subregion(pair):
    img, jimg = pair
    for pkg, image in ((dt, img), (da, jimg)):
        pts = pkg.PointSelectionAssistant(image, points=[[10, 20], [30, 40]])()
        assert np.allclose(np.asarray(pts), [[10, 20], [30, 40]])
        assert pkg.BoxSelectionAssistant(image, width=10, points=[[30, 45], [2, 88]])() == [
            (slice(25, 35), slice(40, 50)),
            (slice(0, 7), slice(83, 90)),
        ]
        assert pkg.RectangleSelectionAssistant(image, corners=[[30, 50], [10.5, 20]])() == (
            slice(10, 30),
            slice(20, 50),
        )
        coords = pkg.SubregionAssistant(image, coordinates=[[0.2, 0.2], [1.0, 1.0]])()
        assert coords.shape == (2, 2)


def test_rotation_assistant(pair):
    img, jimg = pair
    port = dt.RotationCorrectionAssistant(img, points=[[30, 10], [33, 80]])()
    jax = da.RotationCorrectionAssistant(jimg, points=[[30, 10], [33, 80]])()
    assert len(port) == len(jax) == 1
    np.testing.assert_allclose(port[0].rotation, jax[0].rotation, rtol=0, atol=1e-12)
    out = port[0](img)
    want = jax[0](jimg)
    assert out.img.shape == img.img.shape
    assert np.abs(out.img.numpy() - np.asarray(want.img)).max() <= FLOAT_TOL


def _marked(arr):
    arr = arr.copy()
    for r, c in [(3, 3), (56, 4), (57, 86), (2, 85)]:
        arr[r - 1 : r + 2, c - 1 : c + 2] = [1.0, 0.0, 1.0]
    return arr


def test_crop_assistant_from_image():
    arr = _marked(_array())
    meta = {"width": 1.8, "height": 1.2, "color_space": "RGB"}
    port = dt.CropAssistant(dt.Image(torch.from_numpy(arr), **meta), width=1.8, height=1.2)
    jax = da.CropAssistant(da.Image(arr, **meta), width=1.8, height=1.2)
    cfg = port.from_image(color=[1.0, 0.0, 1.0])
    jcfg = jax.from_image(color=[1.0, 0.0, 1.0])
    pts = np.asarray(cfg["crop"]["pts_src"])
    assert pts.shape == (4, 2) and np.array_equal(pts, np.asarray(jcfg["crop"]["pts_src"]))
    # TL, BL, BR, TR near the painted marks.
    assert np.linalg.norm(pts[0] - [3, 3]) < 3 and np.linalg.norm(pts[2] - [57, 86]) < 3
    assert cfg["crop"]["width"] == 1.8 and cfg["crop"]["height"] == 1.2
    cropped = dt.CurvatureCorrection(config=cfg)(dt.Image(torch.from_numpy(arr), **meta))
    want = da.CurvatureCorrection(config=jcfg)(da.Image(arr, **meta))
    assert np.abs(cropped.img.numpy() - np.asarray(want.img)).max() <= FLOAT_TOL
    # Four clicked points through the programmatic path.
    clicked = dt.CropAssistant(dt.Image(torch.from_numpy(arr), **meta), width=1.8, height=1.2, points=pts)()
    assert np.array_equal(np.asarray(clicked["crop"]["pts_src"]), pts)


def test_crop_assistant_on_a_jpeg(tmp_path):
    """Marks on a JPEG photograph: 16-px white blocks aligned to the JPEG's
    MCUs on a flat background decode exactly, so both packages find the
    painted corners."""
    import cv2

    photo = np.full((96, 160, 3), 90, np.uint8)
    for r0, c0 in [(16, 16), (64, 16), (64, 128), (16, 128)]:
        photo[r0 : r0 + 16, c0 : c0 + 16] = 255
    cv2.imwrite(str(tmp_path / "roi.jpg"), photo, [cv2.IMWRITE_JPEG_QUALITY, 95])
    port = dt.CropAssistant(dt.imread(tmp_path / "roi.jpg", device="cpu"), width=1.0, height=0.6)
    jax = da.CropAssistant(da.imread(tmp_path / "roi.jpg"), width=1.0, height=0.6)
    pts = np.asarray(port.from_image(color=[255, 255, 255])["crop"]["pts_src"])
    assert np.array_equal(pts, np.asarray(jax.from_image(color=[255, 255, 255])["crop"]["pts_src"]))
    assert np.array_equal(pts, [[16, 16], [79, 16], [79, 143], [16, 143]])


def test_labels_assistant_roundtrip(pair):
    img, jimg = pair
    la, jla = dt.LabelsAssistant(background=img), da.LabelsAssistant(background=jimg)
    labels = la.segment(marker_points=[[15, 20], [45, 70]])
    jlabels = jla.segment(marker_points=[[15, 20], [45, 70]])
    assert labels.img.dtype == torch.int32 and labels.img.device.type == "cpu"
    assert np.array_equal(labels.img.numpy(), np.asarray(jlabels.img))
    ids = torch.unique(labels.img)[:2].tolist()
    assert len(np.unique(labels.img.numpy())) >= 2
    picked = la.pick(ids=ids[1:])
    jpicked = jla.pick(ids=ids[1:])
    assert np.array_equal(picked.img.numpy(), np.asarray(jpicked.img))
    merged = la.merge(ids=ids)
    jmerged = jla.merge(ids=ids)
    assert np.array_equal(merged.img.numpy(), np.asarray(jmerged.img))
    mask = dt.LabelsMaskSelectionAssistant(merged)(points=[[15, 20]])
    jmask = da.LabelsMaskSelectionAssistant(jmerged)(points=[[15, 20]])
    assert bool(mask[15, 20]) and np.array_equal(mask.numpy(), jmask)
    assert np.array_equal(la.pick(points=[[45, 70]]).img.numpy(), np.asarray(jla.pick(points=[[45, 70]]).img))


def test_labels_refine_splices_a_region(pair):
    img, jimg = pair
    start = np.zeros((60, 90), np.int32)
    start[:, 45:] = 1
    start[30:, :] = 2
    port = dt.LabelsAssistant(dt.Image(torch.from_numpy(start), width=1.8, height=1.2, scalar=True), img)
    jax = da.LabelsAssistant(da.Image(start, width=1.8, height=1.2, scalar=True), jimg)
    out = port.refine(ids=[2], marker_points=[[40, 10], [50, 80]])
    want = jax.refine(ids=[2], marker_points=[[40, 10], [50, 80]])
    assert np.array_equal(out.img.numpy(), np.asarray(want.img))
    assert port() is port.labels


def test_monochromatic_assistant(pair):
    img, jimg = pair
    for color in ("gray", "red", "blue"):
        out = dt.MonochromaticAssistant(img, color=color)()
        want = da.MonochromaticAssistant(jimg, color=color)()
        assert np.abs(out.img.numpy() - np.asarray(want.img)).max() <= FLOAT_TOL


def _click(fig, ax, row, col):
    from matplotlib.backend_bases import MouseButton, MouseEvent

    fig.canvas.draw()
    x, y = ax.transData.transform((col, row))
    event = MouseEvent("button_press_event", fig.canvas, x, y, button=MouseButton.LEFT)
    fig.canvas.callbacks.process("button_press_event", event)


def _key(fig, key):
    from matplotlib.backend_bases import KeyEvent

    fig.canvas.callbacks.process("key_press_event", KeyEvent("key_press_event", fig.canvas, key))


def test_point_selection_event_loop(pair):
    """Clicks add points, 'd' undoes, 'escape' resets, 'enter' finalizes."""
    img, _ = pair
    assistant = dt.PointSelectionAssistant(img, strict=False, block=False)
    assert len(assistant()) == 0
    fig, ax = assistant.fig, assistant.ax
    for row, col in ((10, 20), (30, 40), (50, 60)):
        _click(fig, ax, row, col)
    assert len(assistant.pts) == 3 and len(assistant._markers) == 3
    _key(fig, "d")
    assert len(assistant.pts) == 2 and len(assistant._markers) == 2
    _key(fig, "escape")
    assert assistant.pts == [] and assistant._markers == []
    _click(fig, ax, 12, 34)
    _key(fig, "enter")
    assert assistant.finalized
    pts = assistant()
    assert pts.shape == (1, 2) and np.allclose(pts[0], [12, 34], atol=1.0)


def test_box_subregion_and_menu_event_loops(pair):
    img, _ = pair
    box = dt.BoxSelectionAssistant(img, width=10, strict=False, block=False)
    box()
    _click(box.fig, box.ax, 25, 45)
    _key(box.fig, "enter")
    (rows, cols), = box()
    assert rows.start <= 25 <= rows.stop and cols.start <= 45 <= cols.stop
    sub = dt.SubregionAssistant(img, strict=False, block=False)
    with pytest.raises(AssertionError):
        sub()  # no clicks yet
    _click(sub.fig, sub.ax, 5, 5)
    _click(sub.fig, sub.ax, 55, 85)
    assert np.asarray(sub._clicks).shape == (2, 2)
    bg = dt.Image(torch.zeros(60, 90, dtype=torch.bool), width=1.8, height=1.2, scalar=True)
    menu = dt.LabelsAssistantMenu(img, background=bg, strict=False, block=False)
    assert menu() is None
    _key(menu.fig, "m")
    assert menu.action == "merge"


def test_strict_headless_and_without_matplotlib(pair, monkeypatch):
    img, jimg = pair
    for pkg, image in ((dt, img), (da, jimg)):
        with pytest.raises(RuntimeError, match="interactive"):
            pkg.PointSelectionAssistant(image)()
    assert dt.assistants.interactive_available() is False
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        dt.PointSelectionAssistant(img)()
    # The programmatic path needs no matplotlib.
    assert dt.BoxSelectionAssistant(img, width=4, points=[[10, 10]])() == [(slice(8, 12), slice(8, 12))]
