"""The port's optimal-transport building blocks against the JAX package, on the CPU.

Grids, quadrature, finite-volume reconstructions, the Beckmann stencil
kernels and multigrid, the CG solvers, Anderson mixing, the linear-solver
facades and the dual certificate: the same numpy inputs (made from a seed)
go through both packages.  Tolerances:

- index tables, quadrature rules, sparse matrices: exact;
- stencils (the same float32 arithmetic term for term), reconstructions and
  one V-cycle (its smoother sums in another order; its coarsest level may be
  a float64 matrix): 1e-6 relative to the largest value;
- solves with a fixed iteration count (tol=0): 1e-5; the two libraries sum
  their dot products in another order;
- solves to a tolerance (1e-6): 1e-4, since the float32 stopping rules of
  the two libraries may stop one iteration apart;
- Anderson mixing over a sequence: 1e-5; explicit adjoints (dot-product
  tests): 1e-6; the certificate on one potential: 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import darsia_tpu as da
import darsia_tpu_torch as dt
from darsia_tpu.measure import beckmann_kernels as jbk
from darsia_tpu.utils import andersonacceleration as jaa
from darsia_tpu.utils import quadrature as jq
from darsia_tpu_torch.measure import beckmann_kernels as tbk
from darsia_tpu_torch.utils import andersonacceleration as taa
from darsia_tpu_torch.utils import quadrature as tq

torch.set_num_threads(1)

STENCIL_TOL = 1e-6
FIXED_TOL = 1e-5
LOOP_TOL = 1e-4
CERT_TOL = 1e-4
SHAPES = [(9, 13), (7, 6, 5)]


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _faces(shape, seed=0, low=0.0, high=1.0):
    rng = np.random.default_rng(seed)
    dim = len(shape)
    out = []
    for d in range(dim):
        s = list(shape)
        s[d] -= 1
        out.append(rng.uniform(low, high, s).astype(np.float32))
    return out


def _trans(shape, contrast=100.0, seed=3):
    return [np.exp(np.log(contrast) * f).astype(np.float32) for f in _faces(shape, seed)]


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# ------------------------------------------------------------------ grids


@pytest.mark.parametrize("shape", [(3, 4), (5, 4, 3)], ids=str)
def test_grid_numbering_is_the_jax_packages(shape):
    voxel = [0.5, 0.25, 0.125][: len(shape)]
    g_j, g_t = da.Grid(shape, voxel), dt.Grid(shape, voxel)
    for name in ("num_cells", "num_faces", "num_faces_per_axis", "face_vol", "cell_vol"):
        assert getattr(g_t, name) == getattr(g_j, name), name
    assert [tuple(s) for s in g_t.faces_shape] == [tuple(s) for s in g_j.faces_shape]
    for name in ("cell_index", "connectivity", "reverse_connectivity"):
        assert np.array_equal(getattr(g_t, name), getattr(g_j, name)), name
    for name in ("faces", "face_index", "interior_faces", "exterior_faces"):
        for a, b in zip(getattr(g_t, name), getattr(g_j, name)):
            assert np.array_equal(a, b), name
    flat = np.random.default_rng(1).standard_normal(g_j.num_faces).astype(np.float32)
    arrays_j = g_j.face_arrays(flat)
    for arrays in (g_t.face_arrays(flat), g_t.face_arrays(torch.from_numpy(flat))):
        for a, b in zip(arrays, arrays_j):
            assert np.array_equal(np.asarray(a), b)
    assert np.array_equal(g_t.flat_flux(arrays_j), g_j.flat_flux(arrays_j))
    back = g_t.flat_flux([torch.from_numpy(a) for a in arrays_j])
    assert isinstance(back, torch.Tensor) and np.array_equal(back.numpy(), flat)


def test_generate_grid_from_an_image():
    img = dt.ScalarImage(torch.zeros(6, 8), width=2.0, height=3.0)
    grid = dt.generate_grid(img)
    want = da.generate_grid(da.ScalarImage(np.zeros((6, 8)), width=2.0, height=3.0))
    assert grid.shape == want.shape and np.allclose(grid.voxel_size, want.voxel_size)


# ------------------------------------------------------------- quadrature


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("order", [0, 2, "max"])
def test_quadrature_rules_are_the_jax_packages(dim, order):
    pairs = [
        (tq.gauss(dim, order), jq.gauss(dim, order)),
        (tq.gauss_lobatto(dim, order), jq.gauss_lobatto(dim, order)),
        (tq.gauss_reference_cell(dim, order), jq.gauss_reference_cell(dim, order)),
        (tq.gauss_reference_boundary(dim, order), jq.gauss_reference_boundary(dim, order)),
        (tq.reference_cell_corners(dim), jq.reference_cell_corners(dim)),
    ]
    pairs += [
        (tq.gauss_reference_face(dim, a, s, order), jq.gauss_reference_face(dim, a, s, order))
        for a in range(dim)
        for s in (0, 1)
    ]
    for (pts, w), (pts_j, w_j) in pairs:
        assert np.array_equal(pts, pts_j) and np.array_equal(w, w_j)


# ----------------------------------------------------- finite volumes


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fv_reconstructions_against_jax(shape):
    g_j, g_t = da.Grid(shape, 0.5), dt.Grid(shape, 0.5)
    flat = np.random.default_rng(2).standard_normal(g_j.num_faces).astype(np.float32)
    flat_t = torch.from_numpy(flat)
    for pt in (None, np.array([0.2, 0.7, 0.4])[: len(shape)]):
        _close(dt.face_to_cell(g_t, flat_t, pt), da.face_to_cell(g_j, flat, pt), STENCIL_TOL)
    _close(dt.FVFullFaceReconstruction(g_t)(flat_t), da.FVFullFaceReconstruction(g_j)(flat), STENCIL_TOL)
    tang_t = dt.FVTangentialFaceReconstruction(g_t)(flat_t)
    tang_j = da.FVTangentialFaceReconstruction(g_j)(flat)
    for row_t, row_j in zip(tang_t, tang_j):
        for a, b in zip(row_t, row_j):
            _close(a, b, STENCIL_TOL)
    rng = np.random.default_rng(3)
    dim = len(shape)
    for cell in (
        rng.random(shape),
        rng.random(shape + (dim,)),
        rng.random(shape + (dim, dim)),
    ):
        cell = cell.astype(np.float32)
        for mode in ("arithmetic", "harmonic"):
            _close(
                dt.cell_to_face_average(g_t, torch.from_numpy(cell), mode),
                da.cell_to_face_average(g_j, cell, mode),
                STENCIL_TOL,
            )
    assert (dt.FVDivergence(g_t).mat != da.FVDivergence(g_j).mat).nnz == 0
    for mode in ("cells", "faces"):
        assert (dt.FVMass(g_t, mode).mat != da.FVMass(g_j, mode).mat).nnz == 0


# --------------------------------------------------- stencil kernels


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_stencils_against_jax(shape):
    dim = len(shape)
    face_vol = tuple(0.5 + 0.1 * d for d in range(dim))
    fluxes = [f - 0.5 for f in _faces(shape, seed=4)]
    rng = np.random.default_rng(5)
    p = rng.standard_normal(shape).astype(np.float32)
    cell = (0.1 + rng.random(shape)).astype(np.float32)
    _close(
        tbk.face_divergence(_t(fluxes), face_vol, dim),
        jbk.face_divergence(_j(fluxes), face_vol, dim),
        STENCIL_TOL,
    )
    for a, b in zip(
        tbk.pressure_gradient_faces(torch.from_numpy(p), face_vol, dim),
        jbk.pressure_gradient_faces(jnp.asarray(p), face_vol, dim),
    ):
        _close(a, b, STENCIL_TOL)
    pts, weights = jq.gauss_reference_cell(dim, "max")
    pts, weights = pts.astype(np.float32), weights.astype(np.float32)
    _close(
        tbk.face_to_cell_pt(_t(fluxes), torch.from_numpy(pts[3]), shape, dim),
        jbk.face_to_cell_pt(_j(fluxes), jnp.asarray(pts[3]), shape, dim),
        STENCIL_TOL,
    )
    for w in (1.0, cell):
        _close(
            tbk.transport_density_cells(
                _t(fluxes), torch.from_numpy(pts), torch.from_numpy(weights),
                w if np.isscalar(w) else torch.from_numpy(w), shape, dim,
            ),
            jbk.transport_density_cells(
                _j(fluxes), jnp.asarray(pts), jnp.asarray(weights), w, shape, dim
            ),
            STENCIL_TOL,
        )
    zeros = cell.copy()
    zeros[0] = 0.0  # a zero denominator on the first faces
    for a, b in zip(
        tbk.harmonic_face_average(torch.from_numpy(zeros), dim),
        jbk.harmonic_face_average(jnp.asarray(zeros), dim),
    ):
        _close(a, b, STENCIL_TOL)
    trans = _trans(shape)
    _close(
        tbk.tpfa_apply(torch.from_numpy(p), _t(trans), dim),
        jbk.tpfa_apply(jnp.asarray(p), _j(trans), dim),
        STENCIL_TOL,
    )
    _close(tbk._tpfa_diag(_t(trans), dim), jbk._tpfa_diag(_j(trans), dim), STENCIL_TOL)


@pytest.mark.parametrize("shape", [(9, 13), (7, 6, 5)], ids=str)
def test_multigrid_hierarchy_and_one_vcycle_against_jax(shape, monkeypatch):
    dim = len(shape)
    trans = _trans(shape)
    levels = jbk.tpfa_mg_levels(shape, max_levels=3, coarsest=2)
    assert tbk.tpfa_mg_levels(shape, max_levels=3, coarsest=2) == levels
    for s in [(512, 512), (160, 160), (64, 64, 64), (12, 12, 12), (9, 13)]:
        assert tbk.tpfa_mg_levels(s) == jbk.tpfa_mg_levels(s)
    t_levels = [_t(trans)]
    j_levels = [_j(trans)]
    for _ in range(levels - 1):
        t_levels.append(tbk.tpfa_coarsen_trans(t_levels[-1], dim))
        j_levels.append(jbk.tpfa_coarsen_trans(j_levels[-1], dim))
        for a, b in zip(t_levels[-1], j_levels[-1]):
            _close(a, b, STENCIL_TOL)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    _close(tbk._restrict_cells(torch.from_numpy(x), dim), jbk._restrict_cells(jnp.asarray(x), dim), STENCIL_TOL)
    coarse = tuple((s + 1) // 2 for s in shape)
    xc = rng.standard_normal(coarse).astype(np.float32)
    _close(
        tbk._prolong_cells(torch.from_numpy(xc), shape, dim),
        jbk._prolong_cells(jnp.asarray(xc), shape, dim),
        0.0,
    )
    j_diag = [jbk._tpfa_diag(t, dim) for t in j_levels]
    b = x - x.mean()
    want = jbk._tpfa_vcycle(jnp.asarray(b), j_levels, j_diag, dim, 2, 40)
    # The coarsest level's 42 sweeps as the matrix of that linear map, and as
    # sweeps (a coarsest level above the size limit).
    for limit in (tbk.COARSE_MATRIX_CELLS, 0):
        monkeypatch.setattr(tbk, "COARSE_MATRIX_CELLS", limit)
        hierarchy = tbk.tpfa_mg_hierarchy(_t(trans), dim, levels)
        assert (hierarchy.coarse is None) == (limit == 0)
        for a, b_ in zip(hierarchy.trans, t_levels):
            assert all(torch.equal(u, v) for u, v in zip(a, b_))
        _close(tbk._tpfa_vcycle(torch.from_numpy(b), hierarchy, dim, 2, 40), want, STENCIL_TOL)


def test_batched_stencils_equal_their_loops():
    """Leading batch axes (the direct solver's unit vectors, the certificate's
    quadrature points) give what a loop over them gives."""
    shape = (6, 7)
    trans = _t(_trans(shape))
    batch = torch.randn((3,) + shape, generator=torch.Generator().manual_seed(0))
    loop = torch.stack([tbk.tpfa_apply(b, trans, 2) for b in batch])
    assert torch.equal(tbk.tpfa_apply(batch, trans, 2), loop)
    fluxes = _t(_faces(shape, seed=7))
    pts = torch.tensor([[0.2, 0.3], [0.9, 0.5]])
    each = torch.stack([tbk.face_to_cell_pt(fluxes, q, shape, 2) for q in pts])
    assert torch.equal(tbk.face_to_cell_pt(fluxes, pts, shape, 2), each)


# ---------------------------------------------------------- CG solves


def _rhs(shape, seed=1):
    rhs = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return rhs - rhs.mean()


@pytest.mark.parametrize("shape", [(17, 20), (9, 8, 7)], ids=str)
@pytest.mark.parametrize("solver", ["cg", "mg"])
@pytest.mark.parametrize("tol,maxiter,bound", [(0.0, 4, FIXED_TOL), (1e-6, 400, LOOP_TOL)],
                         ids=["fixed count", "to tolerance"])
def test_cg_solves_against_jax(shape, solver, tol, maxiter, bound):
    """tol=0 runs exactly ``maxiter`` iterations in both libraries; at 1e-6
    their float32 stopping rules may stop one iteration apart (their dot
    products sum in another order), hence the looser bound."""
    dim = len(shape)
    trans = _trans(shape, contrast=50.0)
    rhs = _rhs(shape)
    x0 = np.zeros(shape, np.float32)
    if solver == "cg":
        got = tbk.tpfa_cg(_t(trans), torch.from_numpy(rhs), torch.from_numpy(x0), dim, tol, maxiter)
        want = jbk.tpfa_cg(_j(trans), jnp.asarray(rhs), jnp.asarray(x0), dim=dim, tol=tol, maxiter=maxiter)
    else:
        levels = jbk.tpfa_mg_levels(shape, coarsest=2)
        got = tbk.tpfa_mg_pcg(
            _t(trans), torch.from_numpy(rhs), torch.from_numpy(x0), dim, tol, maxiter, levels
        )
        want = jbk.tpfa_mg_pcg(
            _j(trans), jnp.asarray(rhs), jnp.asarray(x0), dim=dim, tol=tol, maxiter=maxiter,
            levels=levels,
        )
    _close(got, want, bound)


@pytest.mark.parametrize("kind", ["direct", "cg", "amg", "ksp", "ksp-fieldsplit"])
def test_linear_solver_facades_against_jax(kind):
    shape = (12, 10)
    trans = _trans(shape, contrast=20.0)
    rhs = _rhs(shape, seed=2)
    options = {"rtol": 1e-7, "petsc_options": {"ksp_rtol": 1e-7}} if kind.startswith("ksp") else {"rtol": 1e-7}
    s_t = dt.BeckmannLinearSolverFactory.create(kind, shape, dict(options))
    s_j = da.BeckmannLinearSolverFactory.create(kind, shape, dict(options))
    s_t.setup(_t(trans))
    s_j.setup(_j(trans))
    got = s_t.solve(torch.from_numpy(rhs))
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got, s_j.solve(jnp.asarray(rhs)), LOOP_TOL)
    with pytest.raises(ValueError, match="dense"):
        dt.BeckmannDirectSolver((65, 64)).setup(_t(_trans((65, 64))))


# ---------------------------------------------------------- Anderson


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("restart", [None, 3])
def test_anderson_mix_against_jax(depth, restart):
    """A seeded contractive affine fixed point, mixed along the port's own
    trajectory: each step's mixed iterate within 1e-5 of the JAX mixing of
    the same inputs (the history buffers fed alike)."""
    rng = np.random.default_rng(0)
    dim = 40
    M = rng.standard_normal((dim, dim)).astype(np.float32)
    M *= 0.9 / np.max(np.abs(np.linalg.eigvals(M)))
    c = rng.standard_normal(dim).astype(np.float32)
    s_t = taa.anderson_init(dim, depth)
    s_j = jaa.anderson_init(dim, depth)
    x = np.zeros(dim, np.float32)
    for _ in range(12):
        gk = (M @ x + c).astype(np.float32)
        fk = gk - x
        s_t, x_t = taa.anderson_mix(s_t, torch.from_numpy(gk), torch.from_numpy(fk), restart=restart)
        s_j, x_j = jaa.anderson_mix(s_j, jnp.asarray(gk), jnp.asarray(fk), restart=restart)
        _close(x_t, x_j, FIXED_TOL)
        x = x_t.numpy()


def test_anderson_host_class_is_the_jax_packages():
    rng = np.random.default_rng(1)
    a_t, a_j = taa.AndersonAcceleration(None, 3, 4), jaa.AndersonAcceleration(None, 3, 4)
    for it in range(9):
        gk, fk = rng.standard_normal(30), rng.standard_normal(30)
        assert np.array_equal(a_t(gk, fk, it), a_j(gk, fk, it))


# ------------------------------------------------ problem and certificate


def _gaussians(n):
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    src = np.exp(-((x - 0.3) ** 2 + (y - 0.3) ** 2) / 0.02)
    dst = np.exp(-((x - 0.7) ** 2 + (y - 0.6) ** 2) / 0.03)
    return (dst / dst.mean() - src / src.mean()).astype(np.float32)


def _weight(n):
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    return (2.0 + np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy)).astype(np.float32)


N_CERT = 20
CERT_OPTIONS = {"num_iter": 60, "tol_increment": 1e-6, "tol_distance": 1e-6, "L": 1e9}


@pytest.fixture(scope="module")
def jax_solution():
    """One JAX Newton solve per weighting, shared: (solver, fluxes, pressure)."""
    out = {}
    grid = da.Grid((N_CERT, N_CERT), 1.0 / N_CERT)
    md = jnp.asarray(_gaussians(N_CERT))
    for weighted in (False, True):
        weight = _weight(N_CERT) if weighted else None
        solver = da.BeckmannNewtonSolver(grid, weight, CERT_OPTIONS)
        _, fluxes, pressure, _ = solver.solve_beckmann_problem(md)
        out[weighted] = (solver, fluxes, pressure)
    return out


def _port_problem(weighted, cls=None, **options):
    grid = dt.Grid((N_CERT, N_CERT), 1.0 / N_CERT)
    cls = cls or dt.BeckmannNewtonSolver
    return cls(grid, _weight(N_CERT) if weighted else None, {**CERT_OPTIONS, **options})


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_certificate_against_jax(jax_solution, weighted):
    """The raw and the blur-swept certificates on the JAX package's potential;
    unweighted also the exact-gauge value and the polished gap."""
    j_solver, fluxes, pressure = jax_solution[weighted]
    t_solver = _port_problem(weighted)
    md = _gaussians(N_CERT)
    p_t = torch.from_numpy(np.array(pressure))
    fl_t = _t([np.asarray(f) for f in fluxes])
    md_t = torch.from_numpy(md)
    rhs_j = j_solver.cell_vol * jnp.asarray(md)
    rhs_t = t_solver.cell_vol * md_t
    for fn in ("_dual_value", "_dual_value_best"):
        got = float(getattr(t_solver, fn)(p_t, rhs_t))
        want = float(getattr(j_solver, fn)(pressure, rhs_j))
        assert abs(got - want) <= CERT_TOL * abs(want), fn
    # The distance: a sum over the cells in another order.
    want = j_solver.l1_dissipation(fluxes)
    assert abs(t_solver.l1_dissipation(fl_t) - want) <= 1e-5 * want
    if weighted:
        return
    got = t_solver.dual_value_exact(p_t, md_t)
    want = j_solver.dual_value_exact(pressure, jnp.asarray(md))
    assert abs(got - want) <= CERT_TOL * abs(want)
    assert got <= t_solver.l1_dissipation(fl_t) * (1 + 1e-4)
    got = t_solver.duality_gap(fl_t, p_t, md_t, polish_iters=50)
    want = j_solver.duality_gap(fluxes, pressure, jnp.asarray(md), polish_iters=50)
    assert abs(got - want) <= CERT_TOL  # a relative gap: held absolutely


def _dot(a, b):
    if isinstance(a, tuple):
        return sum(float(torch.sum(x.double() * y.double())) for x, y in zip(a, b))
    return float(torch.sum(a.double() * b.double()))


def test_explicit_adjoints_pass_dot_product_tests():
    """<A x, y> = <x, A^T y> for every transpose written out in place of the
    JAX package's jax.vjp: the quadrature interpolant, the gradient (its
    transpose is the divergence), the DST mass solve (symmetric), the
    exact-gauge representer map F and the polish operator."""
    shape = (N_CERT, N_CERT)
    solver = _port_problem(True)
    c = solver._constants("cpu")
    gen = torch.Generator().manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=gen)

    faces = (randn(shape[0] - 1, shape[1]), randn(shape[0], shape[1] - 1))
    nq = c.qp.shape[0]
    cells = randn(nq, *shape, 2)
    lhs = _dot(tbk.face_to_cell_pt(faces, c.qp, shape, 2), cells)
    rhs = _dot(faces, tbk.face_to_cell_pt_adjoint(cells, c.qp, 2))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    p = randn(*shape)
    fv = solver.face_vol
    lhs = _dot(tbk.pressure_gradient_faces(p, fv, 2), faces)
    rhs = _dot(p, tbk.face_divergence(faces, fv, 2))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    for d in range(2):
        x, y = faces[d], randn(*faces[d].shape)
        for eigs in (c.mass_inv, c.mass2_inv):
            lhs = _dot(solver._mass_solve(x, d, eigs), y)
            rhs = _dot(x, solver._mass_solve(y, d, eigs))
            assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    lhs = _dot(solver._F(cells, c), faces)
    rhs = _dot(cells, solver._Ft_scaled(faces, c))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    ops = solver._polish_operators("cpu")
    z = randn(nq, *shape, 2)
    lhs = _dot(ops.A(p), z)
    rhs = _dot(p, ops.At(z))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


MODES = ["cell_based", "cell_based_arithmetic", "cell_based_harmonic", "subcell_based", "face_based"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_face_weights_in_every_mobility_mode(jax_solution, mode, weighted):
    """The face-based mode reconstructs on the tensors' device in float32
    where the JAX package does float64 numpy on the host: equal within
    float32 rounding (2e-6 relative)."""
    j_solver, fluxes, _ = jax_solution[weighted]
    options = {"mobility_mode": mode}
    grid = da.Grid((N_CERT, N_CERT), 1.0 / N_CERT)
    j_mode = da.BeckmannNewtonSolver(grid, _weight(N_CERT) if weighted else None, {**CERT_OPTIONS, **options})
    t_mode = _port_problem(weighted, **options)
    fl_t = _t([np.asarray(f) for f in fluxes])
    for a, b in zip(t_mode.compute_face_weights(fl_t), j_mode.compute_face_weights(fluxes)):
        _close(a, b, 2e-6)


def test_reference_surface_adapters_against_jax(jax_solution):
    j_solver, fluxes, pressure = jax_solution[True]
    t_solver = _port_problem(True)
    fl_t = _t([np.asarray(f) for f in fluxes])
    p_t = torch.from_numpy(np.array(pressure))
    md = _gaussians(N_CERT)
    rhs_t, rhs_j = t_solver.cell_vol * torch.from_numpy(md), j_solver.cell_vol * jnp.asarray(md)
    assert t_solver.ndofs == j_solver.ndofs
    flat_t, flat_j = t_solver.flat_view(fl_t, p_t), j_solver.flat_view(fluxes, pressure)
    _close(flat_t, flat_j, 0.0)
    _close(t_solver.pressure_view(flat_t), j_solver.pressure_view(flat_j), 0.0)
    for a, b in zip(t_solver.flux_view(flat_t), j_solver.flux_view(flat_j)):
        _close(a, b, 0.0)
    _close(t_solver.flat_flux(fl_t), j_solver.flat_flux(fluxes), 0.0)
    fw_t, fw_j = t_solver.compute_face_weights(fl_t), j_solver.compute_face_weights(fluxes)
    block = tuple(torch.full_like(w, 2.0) for w in fw_t)
    _close(
        t_solver.broken_darcy_with_custom_flux_block(block)(flat_t),
        j_solver.broken_darcy_with_custom_flux_block(tuple(jnp.full_like(w, 2.0) for w in fw_j))(flat_j),
        STENCIL_TOL,
    )
    _close(t_solver.exact_linearization(flat_t)(flat_t), j_solver.exact_linearization(flat_j)(flat_j), 1e-5)
    # Off the solution (the residual cancels to ~1e-5 on it).
    off_t, off_j = tuple(1.5 * f for f in fl_t), tuple(1.5 * f for f in fluxes)
    _close(t_solver.compute_residual(off_t, p_t, rhs_t), j_solver.compute_residual(off_j, pressure, rhs_j), 1e-5)
    _close(t_solver.compute_jacobian(fl_t)(p_t), j_solver.compute_jacobian(fluxes)(pressure), 1e-5)
    schur_t, red_t, inv_t = t_solver.eliminate_flux(fw_t, fl_t, rhs_t)
    schur_j, red_j, inv_j = j_solver.eliminate_flux(fw_j, fluxes, rhs_j)
    _close(red_t, red_j, 1e-5)
    _close(schur_t(p_t), schur_j(pressure), 1e-5)
    _, gauge_t = t_solver.eliminate_lagrange_multiplier(schur_t, red_t)
    _, gauge_j = j_solver.eliminate_lagrange_multiplier(schur_j, red_j)
    _close(gauge_t, gauge_j, 1e-5)
    # At the unit mobility (the solution's 1/|u| spans ~1e6: ill-conditioned).
    unit_t, unit_j = tuple(torch.ones_like(w) for w in fw_t), tuple(jnp.ones_like(w) for w in fw_j)
    sol_t, stats = t_solver.linear_solve(unit_t, gauge_t)
    sol_j, _ = j_solver.linear_solve(unit_j, gauge_j)
    assert set(stats) == {"time_setup", "time_solve"}
    _close(sol_t, sol_j, LOOP_TOL)
    assert abs(t_solver.optimality_conditions(fl_t, p_t, rhs_t) - j_solver.optimality_conditions(fluxes, pressure, rhs_j)) <= 1e-4 * j_solver.optimality_conditions(fluxes, pressure, rhs_j)
    for a, b in zip(t_solver.transport_density_faces(fl_t), j_solver.transport_density_faces(fluxes)):
        _close(a, b, 0.0)
    _close(t_solver.cell_weighted_flux(fl_t), j_solver.cell_weighted_flux(fluxes), STENCIL_TOL)


def test_gprox_seams_against_jax(jax_solution):
    j_newton, fluxes, pressure = jax_solution[False]
    grid = da.Grid((N_CERT, N_CERT), 1.0 / N_CERT)
    j_solver = da.BeckmannGproxPGHDSolver(grid, None, {"num_iter": 5})
    t_solver = _port_problem(False, dt.BeckmannGproxPGHDSolver, num_iter=5)
    assert t_solver.amg_options == j_solver.amg_options
    fl_t = _t([np.asarray(f) for f in fluxes])
    md = _gaussians(N_CERT)
    # The potential's Poisson solve has face permeabilities |u| over ten
    # orders of magnitude (the flux vanishes in the corners), computed in
    # float32 here and in float64 there: 1e-2 of the potential's range.
    _close(
        t_solver.compute_kantorovich_potential(torch.from_numpy(md), fl_t),
        j_solver.compute_kantorovich_potential(jnp.asarray(md), fluxes),
        1e-2,
    )
    for a, b in zip(t_solver.leray_projection(fl_t), j_solver.leray_projection(fluxes)):
        _close(a, b, LOOP_TOL)
    p_t = torch.from_numpy(np.array(pressure))
    assert abs(t_solver.compute_dual(p_t, torch.from_numpy(md)) - j_solver.compute_dual(pressure, jnp.asarray(md))) <= 1e-5 * abs(j_solver.compute_dual(pressure, jnp.asarray(md)))
    assert abs(t_solver.compute_primal(fl_t) - j_solver.compute_primal(fluxes)) <= 1e-6 * j_solver.compute_primal(fluxes)


def test_quadrature_modes_and_dtypes_against_jax():
    grid = dt.Grid((6, 6), 1.0)
    for mode in ("raviart_thomas", "constant_subcell_projection", "constant_cell_projection", "face_quadrature"):
        t_p = dt.BeckmannNewtonSolver(grid, None, {"l1_mode": mode})
        j_p = da.BeckmannNewtonSolver(da.Grid((6, 6), 1.0), None, {"l1_mode": mode})
        assert np.array_equal(t_p.quad_pts, np.asarray(j_p.quad_pts))
        assert np.array_equal(t_p.quad_weights, np.asarray(j_p.quad_weights))
    assert dt.BeckmannNewtonSolver(grid, None, {"dtype": "float64"}).dtype == torch.float64
    assert dt.BeckmannNewtonSolver(grid, None, {})._constants("cpu").qp.dtype == torch.float32
