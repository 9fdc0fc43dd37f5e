"""The port's per-frame pipeline against the JAX package, stage by stage.

The scene is the one of ``tests/unit/test_fusedpipeline.py`` (96x128 uint8
RGB, translation + curvature chain, 2x2 registration patches, 5 Jacobi
sweeps), built with the same configs in both packages.  On the CPU both
packages warp with the exact gather, so they agree to float rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.corrections.fuse import fused_chain as jax_fused_chain
from darsia_tpu.restoration.averaging import uniform_filter
from darsia_tpu.utils.linear_solvers import Jacobi as JaxJacobi
from darsia_tpu_torch.convert import operands_from_numpy
from darsia_tpu_torch.corrections.fuse import fused_chain

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (96, 128)
META = {"width": 1.0, "height": 1.0}


def _base_u8(seed=0):
    rng = np.random.default_rng(seed)
    layers = []
    for _ in range(3):
        smooth = np.asarray(
            uniform_filter(jnp.asarray(rng.random(SHAPE, np.float32)), 7)
        )
        layers.append((smooth - smooth.min()) / (smooth.max() - smooth.min()))
    return (np.stack(layers, axis=-1) * 255).astype(np.uint8)


def _configs():
    H, W = SHAPE
    curv = {
        "crop": {
            "pts_src": [[2, 3], [H - 4, 2], [H - 3, W - 3], [2, W - 4]],
            "width": 1.0,
            "height": 1.0,
        },
        "bulge": {"horizontal_bulge": -1e-7, "vertical_bulge": -2e-7},
    }
    return curv, [1.0, -2.0]


def _objects(pkg, jacobi, base_u8, as_input):
    curv_cfg, shift = _configs()
    curv = pkg.CurvatureCorrection(config=curv_cfg)
    trans = pkg.TranslationCorrection(shift)
    f32 = np.float32 if pkg is da else torch.float32
    base_img = pkg.OpticalImage(
        as_input(base_u8), transformations=[trans, curv], **META
    ).img_as(f32)
    analysis = pkg.ConcentrationAnalysis(
        base=base_img,
        signal_reduction=pkg.MonochromaticReduction(color="gray"),
        restoration=lambda s: pkg.H1_regularization(
            s, mu=1.0, omega=0.2, dim=2, solver=jacobi(maxiter=5)
        ),
        model=pkg.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    registration = pkg.ImageRegistration(
        base_img, N_patches=[2, 2], rel_overlap=0.2, quality_tol=0.01
    )
    pipe = pkg.FusedAnalysisPipeline(
        transformations=[trans, curv], registration=registration, analysis=analysis
    )
    return {
        "trans": trans,
        "curv": curv,
        "base": base_img,
        "analysis": analysis,
        "registration": registration,
        "pipe": pipe,
    }


@pytest.fixture(scope="module")
def scene():
    base_u8 = _base_u8()
    probe = np.roll(base_u8, shift=(1, 2), axis=(0, 1))
    j = _objects(da, JaxJacobi, base_u8, jnp.asarray)
    t = _objects(dt, dt.Jacobi, base_u8, torch.from_numpy)
    j_conc = np.asarray(j["pipe"](da.OpticalImage(jnp.asarray(probe), **META)).img)
    t_out = t["pipe"](dt.OpticalImage(torch.from_numpy(probe), **META))
    return {"probe": probe, "jax": j, "torch": t, "j_conc": j_conc, "t_out": t_out}


def test_fused_chain_field(scene):
    j, t = scene["jax"], scene["torch"]
    jf = jax_fused_chain([j["trans"], j["curv"]], SHAPE)
    tf = fused_chain([t["trans"], t["curv"]], SHAPE, CPU)
    assert tf.out_shape == jf.out_shape
    assert tf.max_disp == jf.max_disp
    assert np.abs(tf.field.numpy() - np.asarray(jf.field)).max() <= 1e-4


def test_corrected_baseline_and_metadata(scene):
    jb, tb = scene["jax"]["base"], scene["torch"]["base"]
    assert tb.img.shape == jb.img.shape
    diff = np.abs(tb.img.numpy() - np.asarray(jb.img))
    # uint8 warps round: a field difference at float rounding can flip one
    # level (1/255) where a value sits at a half; none do on this scene.
    assert diff.max() <= 1e-6
    assert np.allclose(tb.dimensions, jb.dimensions)
    assert np.allclose(tb.origin, np.asarray(jb.origin))


def test_patch_shifts(scene):
    j_ta = scene["jax"]["pipe"]._translation_analysis
    t_ta = scene["torch"]["pipe"]._translation_analysis
    j_shifts, j_quality, j_centers = j_ta._pending_shifts
    t_shifts, t_quality, t_centers = t_ta._pending_shifts
    assert np.array_equal(t_centers, j_centers)
    assert np.abs(t_shifts.numpy() - np.asarray(j_shifts)).max() <= 1e-3
    assert np.abs(t_quality.numpy() - np.asarray(j_quality)).max() <= 1e-4


def test_concentration(scene):
    t_out, j_conc = scene["t_out"], scene["j_conc"]
    assert isinstance(t_out, dt.ScalarImage)
    assert t_out.img.shape == j_conc.shape
    assert torch.isfinite(t_out.img).all()
    # The tolerance the JAX package holds between its own lanes.
    assert np.abs(t_out.img.numpy() - j_conc).max() <= 1e-4
    assert np.allclose(t_out.dimensions, scene["jax"]["base"].dimensions)


def _jax_operands(scene):
    pipe = scene["jax"]["pipe"]
    _, operands = pipe._build(SHAPE, np.uint8, False)
    return jax.tree_util.tree_map(np.asarray, operands)


def test_own_setup_products_equal_jax(scene):
    j_ops = _jax_operands(scene)
    _, t_ops = scene["torch"]["pipe"]._build(SHAPE, torch.uint8, CPU)
    assert set(t_ops) == set(j_ops) == {"field_0", "reg", "base"}
    assert set(t_ops["reg"]) == set(j_ops["reg"])
    assert np.abs(t_ops["field_0"].numpy() - j_ops["field_0"]).max() <= 1e-4
    assert np.abs(t_ops["base"].numpy() - j_ops["base"]).max() <= 1e-6
    reg_t, reg_j = t_ops["reg"], j_ops["reg"]
    assert reg_t["centers"].dtype == torch.int32
    assert np.array_equal(reg_t["centers"].numpy(), reg_j["centers"])
    for key in ("Ainv_x", "Ainv_y", "E_x", "E_y"):
        # Same float64 host computation, rounded to f32 once.
        assert np.array_equal(reg_t[key].numpy(), reg_j[key]), key
    spec_t, spec_j = reg_t["base_spectra"].numpy(), reg_j["base_spectra"]
    assert spec_t.dtype == spec_j.dtype == np.complex64
    # Two FFT libraries: agreement relative to the spectrum's scale.
    assert np.abs(spec_t - spec_j).max() <= 1e-5 * np.abs(spec_j).max()


def test_run_on_jax_operands(scene):
    ops = operands_from_numpy(_jax_operands(scene), CPU)
    assert ops["reg"]["base_spectra"].dtype == torch.complex64
    out = scene["torch"]["pipe"](torch.from_numpy(scene["probe"]), operands=ops)
    assert np.abs(out.img.numpy() - scene["j_conc"]).max() <= 1e-4


def test_plain_warp_impl_is_the_same_on_cpu(scene):
    pipe = scene["torch"]["pipe"]
    probe = torch.from_numpy(scene["probe"])
    a = pipe(probe).img
    b = pipe(probe, warp_impl="plain").img
    assert torch.equal(a, b)
    assert torch.equal(a, scene["t_out"].img)


def test_staged_public_objects(scene):
    """Image(transformations) -> ImageRegistration -> ConcentrationAnalysis."""
    j, t = scene["jax"], scene["torch"]
    probe = scene["probe"]
    j_img = da.OpticalImage(jnp.asarray(probe), transformations=[j["trans"], j["curv"]], **META)
    t_img = dt.OpticalImage(
        torch.from_numpy(probe), transformations=[t["trans"], t["curv"]], **META
    )
    assert np.abs(t_img.img.numpy().astype(int) - np.asarray(j_img.img).astype(int)).max() == 0
    j_reg = j["registration"](j_img.img_as(np.float32))
    t_reg = t["registration"](t_img.img_as(torch.float32))
    tr, jr = t_reg.img.numpy(), np.asarray(j_reg.img)
    off = (np.abs(tr - jr) > 1e-5).any(axis=-1)
    # A sample position within rounding of the domain edge (zero TPS
    # displacement at a boundary point) can land on either side of the
    # mode="constant" mask: such pixels are filled (0) in one package only.
    assert off.sum() <= 4
    assert all((tr[p] == 0).all() or (jr[p] == 0).all() for p in zip(*np.nonzero(off)))
    assert np.abs(tr - jr)[~off].max() <= 1e-5
    j_conc = np.asarray(j["analysis"](j_reg).img)
    t_conc = t["analysis"](t_reg).img.numpy()
    assert np.abs(t_conc - j_conc).max() <= 1e-4
    assert np.abs(t_conc - scene["j_conc"]).max() <= 1e-4
