"""The port's filters, H1 regularization, averaging and mask clean-up against
the JAX package, on the CPU.

Same numpy inputs (made from a seed) to both packages.  Tolerances on
unit-range float32 images: H1 regularization with a fixed count of sweeps
2e-6, with CG 1e-5; the median filter picks input values, so it is exact;
the uniform filter sums windows in another order, 1e-6; host-side numpy code
(morphology, binary inpainting) is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.restoration.averaging import porosity_based_averaging as jax_porosity_averaging
from darsia_tpu.restoration.averaging import uniform_filter as jax_uniform_filter

torch.set_num_threads(1)

META = {"width": 0.4, "height": 0.3}


def _image(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _field(shape, seed=1):
    return (0.3 + np.random.default_rng(seed).random(shape)).astype(np.float32)


# --------------------------------------------------------- H1 regularization


@pytest.mark.parametrize("solver", ["Jacobi", "CG", "MG"])
@pytest.mark.parametrize("weights", ["scalar", "field"])
def test_h1_regularization_against_jax(weights, solver):
    img = _image((37, 50))
    mu, omega = (2.0, 0.5) if weights == "scalar" else (_field((37, 50)), _field((37, 50), 2))
    kw = {"Jacobi": {"maxiter": 12}, "CG": {"maxiter": 12}, "MG": {"maxiter": 2, "depth": 2}}[solver]
    as_jax = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v  # noqa: E731
    want = np.asarray(
        da.H1_regularization(
            jnp.asarray(img), as_jax(mu), as_jax(omega), solver=getattr(da, solver)(**kw)
        )
    )
    got = dt.H1_regularization(torch.from_numpy(img), mu, omega, solver=getattr(dt, solver)(**kw))
    assert np.abs(got.numpy() - want).max() <= (1e-5 if solver == "CG" else 2e-6)


def test_h1_regularization_default_solver_3d_and_numpy_against_jax():
    vol = _image((10, 12, 14), seed=3)
    want = np.asarray(da.H1_regularization(jnp.asarray(vol), 1.5, 0.4, dim=3))
    got = dt.H1_regularization(vol, 1.5, 0.4, dim=3, device="cpu")
    assert np.abs(got.numpy() - want).max() <= 2e-6
    mu = _field((10, 12, 14), 4)
    want = np.asarray(da.H1_regularization(jnp.asarray(vol), jnp.asarray(mu), 0.4, dim=3))
    got = dt.H1_regularization(torch.from_numpy(vol), mu, 0.4, dim=3)
    assert np.abs(got.numpy() - want).max() <= 2e-6


@pytest.mark.parametrize("solver", ["Jacobi", "CG", "MG", "MG_tol"])
def test_h1_regularization_channels_against_jax_and_channel_by_channel(solver):
    """Trailing channels: one batched solve for the elementwise solvers
    (Jacobi, MG with a fixed count), bitwise what the channels alone give;
    CG and MG with a tolerance reduce over the tensor and go channel by
    channel."""
    img = _image((24, 30, 3), seed=5)
    mu = _field((24, 30), 6)
    make = {
        "Jacobi": lambda pkg: pkg.Jacobi(maxiter=8),
        "CG": lambda pkg: pkg.CG(maxiter=8),
        "MG": lambda pkg: pkg.MG(maxiter=2, depth=2),
        "MG_tol": lambda pkg: pkg.MG(maxiter=6, depth=2, tol=1e-3),
    }[solver]
    got = dt.H1_regularization(torch.from_numpy(img), mu, 0.5, solver=make(dt))
    alone = torch.stack(
        [
            dt.H1_regularization(torch.from_numpy(img[..., c].copy()), mu, 0.5, solver=make(dt))
            for c in range(3)
        ],
        dim=-1,
    )
    assert torch.equal(got, alone)
    want = np.asarray(da.H1_regularization(jnp.asarray(img), jnp.asarray(mu), 0.5, solver=make(da)))
    assert np.abs(got.numpy() - want).max() <= (2e-6 if solver in ("Jacobi", "MG") else 1e-5)


def test_h1_regularization_on_images_keeps_type_and_dtype():
    img = (_image((24, 30, 3), seed=7) * 255).astype(np.uint8)
    j = da.H1_regularization(da.OpticalImage(jnp.asarray(img), **META), 1.0, 0.5)
    source = dt.OpticalImage(torch.from_numpy(img), **META)
    t = dt.H1_regularization(source, 1.0, 0.5)
    assert type(t) is dt.OpticalImage and t.img.dtype == torch.uint8
    assert np.abs(t.img.numpy().astype(int) - np.asarray(j.img).astype(int)).max() <= 1


# -------------------------------------------------------------------- median


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_median_filter_against_jax(radius):
    img = _image((29, 34), seed=8)
    want = np.asarray(da.median_filter(jnp.asarray(img), radius))
    got = dt.median_filter(torch.from_numpy(img), radius)
    assert np.array_equal(got.numpy(), want)


def test_median_filter_wraps_at_the_border_as_in_jax():
    """The shifts are rolls (darsia_tpu restoration/median.py:23-27): a bright
    bottom row reaches the top row's median."""
    img = np.zeros((9, 9), np.float32)
    img[-1] = 1.0
    img[0, 4] = 1.0
    got = dt.median_filter(torch.from_numpy(img), 1).numpy()
    want = np.asarray(da.median_filter(jnp.asarray(img), 1))
    assert np.array_equal(got, want)
    # (0, 4) sees itself and, through the wrap, (8, 4): two of five, so 0.
    assert got[8, 4] == 1.0 and got[0, 4] == 0.0 and got[1, 4] == 0.0
    # With its two row neighbours lit it has four of five; without the wrap
    # it would have three of five all the same, so also test the corner.
    img[0, 3:6] = 1.0
    assert dt.median_filter(torch.from_numpy(img), 1).numpy()[0, 4] == 1.0
    corner = np.zeros((9, 9), np.float32)
    corner[0, 0] = corner[8, 0] = corner[0, 8] = 1.0  # neighbours only by the wrap
    assert dt.median_filter(torch.from_numpy(corner), 1).numpy()[0, 0] == 1.0
    assert np.asarray(da.median_filter(jnp.asarray(corner), 1))[0, 0] == 1.0


def test_median_objects_colour_images_and_odd_count():
    img = _image((20, 24, 3), seed=9)
    j = da.Median(**{"restoration disk radius": 2}, key="restoration ")
    t = dt.Median(**{"restoration disk radius": 2}, key="restoration ")
    assert t.disk_radius == 2 and dt.Median().disk_radius == 1
    assert np.array_equal(t(torch.from_numpy(img)).numpy(), np.asarray(j(jnp.asarray(img))))
    source = dt.OpticalImage(torch.from_numpy(img), **META)
    out = t(source)
    assert type(out) is dt.OpticalImage and out.img is not source.img
    assert np.array_equal(out.img.numpy(), np.asarray(j(da.OpticalImage(jnp.asarray(img), **META)).img))
    for radius in range(6):
        assert dt.morphology.disk(radius).sum() % 2 == 1


# ----------------------------------------------------------------- averaging


@pytest.mark.parametrize("size", [1, 2, 3, 4, 7, 10])
def test_uniform_filter_odd_and_even_sizes_against_jax(size):
    """An even window is off-centre ((size - 1) // 2 below, size // 2 above),
    as XLA's SAME padding places it."""
    data = _image((23, 31), seed=10)
    want = np.asarray(jax_uniform_filter(jnp.asarray(data), size))
    got = dt.uniform_filter(torch.from_numpy(data), size).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(dt.uniform_filter(torch.ones(23, 31), size).numpy() - 1).max() <= 1e-6


@pytest.mark.parametrize("rev_length", [0.021, 0.04])
def test_volume_averaging_against_jax(rev_length):
    data = _image((30, 40), seed=11)
    mask = (_image((30, 40), seed=12) > 0.3).astype(np.float32)
    mask[5:12, 8:20] = 0.0  # a region without pore space: averaged to 0
    j_img = da.ScalarImage(jnp.asarray(data), **META)
    t_img = dt.ScalarImage(torch.from_numpy(data), **META)
    j_rev, t_rev = da.REV(rev_length, j_img), dt.REV(rev_length, t_img)
    assert t_rev.size == j_rev.size and t_rev.size in (3, 4)
    assert dt.REV([0.03, 0.01], t_img).size == da.REV([0.03, 0.01], j_img).size
    j_avg = da.VolumeAveraging(j_rev, da.ScalarImage(jnp.asarray(mask), **META))
    t_avg = dt.VolumeAveraging(t_rev, dt.ScalarImage(torch.from_numpy(mask), **META))
    assert np.abs(t_avg.mean_pore_volume.numpy() - j_avg.mean_pore_volume).max() <= 1e-6
    assert np.array_equal(t_avg.zero_mask.numpy(), j_avg.zero_mask)
    out = t_avg(t_img)
    assert type(out) is dt.ScalarImage
    assert np.abs(out.img.numpy() - np.asarray(j_avg(j_img).img)).max() <= 2e-6
    # Tensors and multichannel arrays; a numpy mask with its device.
    rgb = _image((30, 40, 3), seed=13)
    t_np = dt.VolumeAveraging(t_rev, mask, device="cpu")
    want = np.asarray(da.VolumeAveraging(j_rev, mask)(jnp.asarray(rgb)))
    assert np.abs(t_np(torch.from_numpy(rgb)).numpy() - want).max() <= 2e-6
    assert np.abs(dt.volume_average(t_img, t_avg.mask, rev_length).img.numpy()
                  - np.asarray(da.volume_average(j_img, j_avg.mask, rev_length).img)).max() <= 2e-6
    with pytest.raises(ValueError):
        t_np(torch.zeros(2, 3, 4, 5))


def test_porosity_based_averaging_against_jax():
    labels = np.zeros((30, 40), int)
    labels[:, 20:] = 1
    labels[18:, :] += 2
    porosity = _image((30, 40), seed=14)
    data = _image((30, 40), seed=15)
    j_ref = da.ScalarImage(jnp.asarray(data), **META)
    t_ref = dt.ScalarImage(torch.from_numpy(data), **META)
    kw = {"threshold": 0.3, "disk_size": 2, "rev_size": 0.03}
    j_avg = jax_porosity_averaging(labels, porosity, j_ref, **kw)
    t_avg = dt.porosity_based_averaging(
        dt.ScalarImage(torch.from_numpy(labels), **META), torch.from_numpy(porosity), t_ref, **kw
    )
    assert np.array_equal(np.asarray(t_avg.mask), np.asarray(j_avg.mask))
    assert (np.asarray(t_avg.mask)[:, 18:22] == 0).all()  # the layer boundary
    assert np.abs(t_avg(t_ref).img.numpy() - np.asarray(j_avg(j_ref).img)).max() <= 2e-6


# ------------------------------------------------- morphology and inpainting


def _mask(seed=16, shape=(40, 48)):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.72
    mask[5:15, 6:20] = True
    mask[8:11, 9:12] = False  # a hole
    mask[25:35, 30:44] = True
    return mask


@pytest.mark.parametrize(
    "name, args",
    [
        ("disk", (3,)),
        ("binary_dilation", (None,)),
        ("binary_erosion", (None,)),
        ("remove_small_objects", (6,)),
        ("remove_small_holes", (12,)),
        ("binary_fill_holes", ()),
        ("convex_hull_image", ()),
        ("skeletonize", ()),
        ("find_boundaries", ()),
    ],
)
def test_morphology_against_jax(name, args):
    fj, ft = getattr(da.morphology, name), getattr(dt.morphology, name)
    if name == "disk":
        assert np.array_equal(ft(*args), fj(*args))
        return
    mask = _mask()
    data = np.cumsum(mask, axis=1) // 4 if name == "find_boundaries" else mask
    if name in ("binary_dilation", "binary_erosion"):
        args = (dt.morphology.disk(2),)
    assert np.array_equal(ft(data, *args), fj(data, *args))


def test_label_and_degenerate_hulls_against_jax():
    mask = _mask(17)
    for connectivity in (1, 2):
        lt, nt = dt.morphology.label(mask, connectivity)
        lj, nj = da.morphology.label(mask, connectivity)
        assert nt == nj and np.array_equal(lt, lj)
    line = np.zeros((8, 8), bool)
    line[3, 1:7] = True  # collinear: no hull, the mask comes back
    assert np.array_equal(dt.morphology.convex_hull_image(line), line)
    assert np.array_equal(da.morphology.convex_hull_image(line), line)
    two = np.zeros((8, 8), bool)
    two[1, 1] = two[5, 6] = True
    assert np.array_equal(dt.morphology.convex_hull_image(two), two)


@pytest.mark.parametrize(
    "name, option, value",
    [
        ("BinaryRemoveSmallObjects", "remove small objects size", 6),
        ("BinaryFillHoles", "fill holes size", 12),
        ("BinaryLocalConvexCover", "local convex cover size", 8),
    ],
)
def test_binary_inpainting_against_jax(name, option, value):
    mask = _mask(18)
    for make in (
        lambda pkg: getattr(pkg, name)(value),
        lambda pkg: getattr(pkg, name)(key="seg ", **{"seg " + option: value}),
        lambda pkg: getattr(pkg, name)(),  # the default leaves the mask as it is
    ):
        want = make(da)(mask)
        assert np.array_equal(make(dt)(mask), want)
        # A tensor mask is copied to the host.
        got = make(dt)(torch.from_numpy(mask))
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)


# ----------------------------------------------------------- combined model


def test_combined_restoration_chain_against_jax():
    """``CombinedModel([Resize, TVD, Resize])``, built as the FluidFlower
    presets build their ``restoration=`` (presets/fluidflower/
    benchmarkco2model.py:52-58), on tensors and on images."""
    signal = _image((48, 64), seed=19)
    options = {
        "restoration resize x": 0.5,
        "restoration resize y": 0.5,
        "restoration method": "isotropic bregman",
        "restoration weight": 0.1,
        "restoration max_num_iter": 6,
        "restoration eps": 1e-4,
    }

    def chain(pkg, base):
        # The TVD gets its own options only: with a Bregman method it passes
        # every other one on to split_bregman_tvd, which refuses it
        # (darsia_tpu restoration/tvd.py:39, :59-66; mirrored, see below).
        tvd_options = {k: v for k, v in options.items() if "resize" not in k}
        return pkg.CombinedModel(
            [
                pkg.Resize(key="restoration ", **options),
                pkg.TVD(key="restoration ", **tvd_options),
                pkg.Resize(ref_image=base),
            ]
        )

    j_base = da.ScalarImage(jnp.asarray(signal), **META)
    t_base = dt.ScalarImage(torch.from_numpy(signal), **META)
    cj, ct = chain(da, j_base), chain(dt, t_base)
    assert ct.num_parameters == cj.num_parameters == 0 and isinstance(ct[1], dt.TVD)
    want = np.asarray(cj(jnp.asarray(signal)))
    got = ct(torch.from_numpy(signal))
    assert tuple(got.shape) == (48, 64)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    out = ct(t_base)
    assert type(out) is dt.ScalarImage and out.dimensions == t_base.dimensions
    assert np.abs(out.img.numpy() - np.asarray(cj(j_base).img)).max() <= 1e-5
    assert torch.equal(ct.call_array(torch.from_numpy(signal)), got)
    # All the options at once: fine for Chambolle, refused by a Bregman method.
    mixed = {**options, "restoration method": "chambolle"}
    assert dt.TVD(key="restoration ", **mixed)(torch.from_numpy(signal)).shape == (48, 64)
    for pkg, data in ((da, jnp.asarray(signal)), (dt, torch.from_numpy(signal))):
        with pytest.raises(TypeError, match="restoration resize x"):
            pkg.TVD(key="restoration ", **options)(data)


def test_combined_model_passes_arguments_and_parameters():
    class Scale(dt.Model):
        num_parameters = 1

        def __init__(self):
            self.factor = 1.0

        def call_array(self, signal, shift=0.0):
            return self.factor * signal + shift

        def update_model_parameters(self, parameters, dofs=None):
            self.factor = float(parameters[0])

    class Double:
        def __call__(self, signal):
            return 2.0 * signal

    chain = dt.CombinedModel([Scale(), Double(), Scale()])
    assert chain.num_parameters == 2
    chain.update_model_parameters([3.0, 5.0])
    x = torch.ones(2, 2)
    # Further arguments go to the models whose call takes them.
    assert torch.equal(chain(x, 1.0), ((3.0 * x + 1.0) * 2.0) * 5.0 + 1.0)
    with pytest.raises(NotImplementedError):
        dt.Model()(x)
