"""Where the port's entry points run: the CUDA card unless the caller asks.

A numpy input to ``Image`` or ``FusedAnalysisPipeline`` goes to ``device``,
the card when None; with no card that raises and names ``device="cpu"``.
A tensor input stays where it is.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import darsia_tpu_torch as dt

torch.set_num_threads(1)


@pytest.fixture
def no_card():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        yield


@pytest.mark.parametrize("cls", [dt.Image, dt.ScalarImage, dt.OpticalImage])
def test_numpy_input_without_a_card_raises(no_card, cls):
    arr = np.zeros((4, 4, 3)) if cls is dt.OpticalImage else np.zeros((4, 4))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(arr)


def test_numpy_input_goes_to_the_requested_device(no_card):
    img = dt.Image(np.zeros((4, 4)), device="cpu")
    assert img.device.type == "cpu"
    assert img.copy().device.type == "cpu"


def test_tensor_input_stays_where_it_is(no_card):
    t = torch.zeros((4, 5, 3), dtype=torch.uint8)
    img = dt.OpticalImage(t)
    assert img.img is t
    assert dt.ScalarImage(torch.zeros((4, 5))).device.type == "cpu"


def test_pipeline_numpy_input_without_a_card_raises(no_card):
    base = dt.OpticalImage(np.full((16, 16, 3), 0.5, np.float32), device="cpu")
    analysis = dt.ConcentrationAnalysis(
        base=base,
        signal_reduction=dt.MonochromaticReduction(color="gray"),
        model=dt.LinearModel(scaling=2.0),
    )
    pipe = dt.FusedAnalysisPipeline(analysis=analysis)
    frame = np.full((16, 16, 3), 0.75, np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pipe(frame)
    out = pipe(frame, device="cpu")
    assert out.device.type == "cpu"
    assert torch.equal(out.img, pipe(torch.from_numpy(frame)).img)


def test_resize_numpy_input_without_a_card_raises(no_card):
    """``Resize`` sent numpy input to the CPU; it now goes to the card."""
    frame = np.zeros((8, 10), np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dt.Resize(shape=(4, 5))(frame)
    assert dt.Resize(shape=(4, 5))(torch.from_numpy(frame)).device.type == "cpu"


def test_colour_to_mass_numpy_input_without_a_card_raises(no_card):
    path = dt.ColorPath(colors=[np.zeros(3), np.ones(3)])
    colors = np.full((4, 5, 3), 0.5, np.float32)
    signal = np.full((4, 5), 0.5, np.float32)
    labels = torch.zeros((4, 5), dtype=torch.int64)
    calls = [
        lambda: path.fit(colors, dt.ColorMode.ABSOLUTE),
        lambda: dt.ColorPathInterpolation(path, dt.ColorMode.ABSOLUTE)(colors),
        lambda: dt.PWTransformation([0, 1], [0, 2])(signal),
        lambda: dt.ClipModel(0.0, 1.0)(signal),
        lambda: dt.HeterogeneousModel(dt.ClipModel(0.0, 1.0), labels)(signal),
        lambda: dt.get_mean_color(colors),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert dt.HeterogeneousModel(dt.ClipModel(0.0, 1.0), labels)(torch.from_numpy(signal)).device.type == "cpu"


def test_rig_config_and_setup_entry_points_default_to_the_card(no_card, tmp_path):
    """``device=None`` (the card) in every rig, setup, embedding and
    comparison entry point; without a card each raises naming
    ``device="cpu"`` before it reads or writes anything."""
    import inspect

    from darsia_tpu_torch.presets.workflows import setup
    from darsia_tpu_torch.presets.workflows.comparison import comparison_wasserstein

    entry_points = [
        setup.setup_rig,
        setup.setup_depth_map,
        setup.segment_colored_image,
        setup.setup_facies,
        dt.Rig.setup,
        dt.Rig.load,
        dt.ColorEmbeddingRuntime,
        comparison_wasserstein,
    ]
    for entry in entry_points:
        assert inspect.signature(entry).parameters["device"].default is None, entry
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dt.ColorEmbeddingRuntime(rig=None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dt.Rig.load(tmp_path / "absent")
    config = tmp_path / "config.toml"
    config.write_text(
        f'[rig]\nwidth = 1.0\nheight = 1.0\ndim = 2\nresolution = [4, 6]\npath = "{tmp_path / "rig"}"\n'
        f'[depth]\nmeasurements = "{tmp_path / "depth.csv"}"\ndepth_map = "{tmp_path / "depth.npz"}"\n'
    )
    (tmp_path / "depth.csv").write_text("x,y,mean\n0,0,1\n1,0,1\n0,1,1\n1,1,2\n")
    with pytest.warns(UserWarning), pytest.raises(RuntimeError, match='device="cpu"'):
        setup.setup_depth_map(config)
    assert not (tmp_path / "depth.npz").exists()
