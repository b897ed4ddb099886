"""The step's XSPH and Akinci surface-tension options and ``energy_rate`` in
the torch port, against the JAX package on the CPU: each plain pair pass
against the reference's jnp pass on the same dense layout (up to 64 slots
and past them, closed and periodic), the fold constants the CUDA kernels
use, ``energy_rate``, and the reference's physical checks mirrored on the
port (the two-tier passes and the ghost-halo route are in
tests/test_torch_options_tiers.py, the steps with the options in
tests/test_torch_options_steps.py).
The kernels themselves are held to these plain passes on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: a pass and ``energy_rate`` rtol 1e-4, atol 1e-5 on each plane
scaled by its max (the acceleration tolerance of
tests/test_pallas_ops.py); the fold constants 1e-12 relative in float64;
the cohesion spline 1e-6 relative.  The sums run in another order in each
implementation.
"""

import math

import numpy
import pytest
import torch

import jax.numpy as jnp

from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import energy_rate as ref_energy_rate
from tpgsd.sph.cells import build_cells as ref_build_cells
from tpgsd.sph.cells import neighbor_table as ref_neighbor_table
from tpgsd.sph.cells import scatter_to_cells as ref_scatter_to_cells
from tpgsd.sph.kernels import WendlandC2 as RefWendlandC2
from tpgsd.sph.step import _cohesion_blocks as ref_cohesion_blocks
from tpgsd.sph.step import _energy_blocks as ref_energy_blocks
from tpgsd.sph.step import _mimage_of as ref_mimage_of
from tpgsd.sph.step import _st_force_blocks as ref_st_force_blocks
from tpgsd.sph.step import _st_normals_blocks as ref_st_normals_blocks
from tpgsd.sph.step import _xsph_blocks as ref_xsph_blocks
from tpgsd_torch.sph import (
    CubicSpline,
    SPHParams,
    SPHState,
    WendlandC2,
    dam_break,
    density_and_pressure,
    energy_rate,
    init_density,
    make_grid,
    make_step_fn,
    ops,
)
from tpgsd_torch.sph.cells import (
    build_cells,
    gather_from_cells,
    scatter_to_cells_soa,
    wrap_axes,
)
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.step import (
    _accel_blocks,
    _cohesion_c,
    _density_blocks,
    _xsph_blocks,
    neighbor_index,
    tait_pressure,
)

GAMMA = 0.05  # the surface-tension strength of tests/test_spill.py


def _scaled_close(got, want, live, rtol=1e-4, atol=1e-5, err_msg=""):
    """``got`` against ``want`` on ``live`` slots, scaled by max|want|."""
    got, want = numpy.asarray(got)[live], numpy.asarray(want)[live]
    scale = float(numpy.abs(want).max())
    assert scale > 0.0, "the reference plane is zero"
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                                  atol=atol, err_msg=err_msg)


def _planes_close(got_soa, want_aos, live, err_msg=""):
    """Each plane of a port ``[3, C, K]`` result against the reference's
    ``[C, K, 3]``."""
    for d in range(3):
        _scaled_close(got_soa[d].numpy(), numpy.asarray(want_aos)[..., d],
                      live, err_msg="%s plane %d" % (err_msg, d))


def _moving(x0, spacing, seed, v_scale=0.5, jitter=0.05):
    rng = numpy.random.default_rng(seed)
    x = x0 + (jitter * spacing) * rng.standard_normal(x0.shape)
    v = v_scale * rng.standard_normal(x0.shape)
    return x.astype(numpy.float32), v.astype(numpy.float32)


def _finish(rho, mask, params):
    rho = torch.where(mask, torch.clamp(rho, min=0.1 * params.rho0), params.rho0)
    return rho, torch.where(mask, tait_pressure(rho, params), 0.0)


# --------------------------------------------------------------------------
# each plain pass against the reference's jnp pass, one dense layout
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(48, False), (48, True), (72, False),
                                        (72, True)],
                ids=["K48-closed", "K48-periodic", "K72-closed",
                     "K72-periodic"])
def dense_case(request):
    """A jittered dam break with N(0, 0.25) velocities in both packages'
    single-tier layout at capacity K (K = 72: past the two-tier kernels'
    64 slots), with the port's finished density and pressure handed to
    both, and the reference's normals."""
    k, periodic = request.param
    db = ref_dam_break(n_side=8, capacity=k)
    x, v = _moving(numpy.asarray(db.state.x), db.params.h / 1.3, seed=k)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    c = grid.n_cells
    cells = build_cells(torch.from_numpy(x), grid)
    xv = scatter_to_cells_soa(torch.from_numpy(numpy.concatenate([x, v], 1)),
                              cells, grid)
    m = cells.mask[:c]
    wrap = ops._wrapped(wrap_axes(grid, periodic))
    rho, p = _finish(ops.density_plain(xv[:3], m, grid, params, wrap_axes=wrap),
                     m, params)
    port = (xv[:3], xv[3:], rho, p, m)

    cells_r = ref_build_cells(jnp.asarray(x), db.grid)
    dense = ref_scatter_to_cells(jnp.asarray(numpy.concatenate([x, v], 1)),
                                 cells_r, db.grid)
    assert (numpy.asarray(cells_r.mask)[:c] == m.numpy()).all()

    def sentinel(a, fill):
        a = numpy.asarray(a)
        pad = numpy.full((1,) + a.shape[1:], fill, a.dtype)
        return jnp.asarray(numpy.concatenate([a, pad]))

    nbr = ref_neighbor_table(db.grid, periodic=periodic)
    mimage = ref_mimage_of(db.grid, periodic)
    rho_r, p_r = sentinel(rho.numpy(), params.rho0), sentinel(p.numpy(), 0.0)
    normals_r = ref_st_normals_blocks(dense[..., :3], rho_r, cells_r.mask, nbr,
                                      db.params, RefWendlandC2, 32,
                                      mimage=mimage)
    ref = {
        "args": (dense[..., :3], dense[..., 3:], rho_r, p_r, cells_r.mask, nbr),
        "params": db.params, "mimage": mimage, "normals": normals_r,
        "normals_s": sentinel(normals_r, 0.0),
    }
    return {"grid": grid, "params": params, "port": port, "wrap": wrap,
            "ref": ref, "live": m.numpy(), "k": k}


@pytest.mark.parametrize("pass_name", ["xsph", "st_normals", "st_force",
                                       "energy"])
def test_plain_pass_matches_reference(dense_case, pass_name):
    s = dense_case
    grid, params, wrap = s["grid"], s["params"], s["wrap"]
    x, v, rho, p, m = s["port"]
    rx, rv, rrho, rp, rmask, nbr = s["ref"]["args"]
    rparams, mimage = s["ref"]["params"], s["ref"]["mimage"]
    if pass_name == "xsph":
        got = ops.xsph_pairs_plain(*s["port"], *s["port"], grid, params,
                                   wrap_axes=wrap)
        want = ref_xsph_blocks(rx, rv, rrho, rmask, nbr, rparams, RefWendlandC2,
                               32, mimage=mimage)
        _planes_close(got, want, s["live"], pass_name)
    elif pass_name == "st_normals":
        got = ops.st_normals_pairs_plain(x, m, x, rho, m, grid, params,
                                         wrap_axes=wrap)
        _planes_close(got, s["ref"]["normals"], s["live"], pass_name)
    elif pass_name == "st_force":
        # both get the reference's normals, so the force pass alone is held
        n = torch.from_numpy(numpy.ascontiguousarray(
            numpy.moveaxis(numpy.asarray(s["ref"]["normals"]), -1, 0)))
        got = ops.st_force_pairs_plain(x, n, rho, m, x, n, rho, m, grid, params,
                                       GAMMA, wrap_axes=wrap)
        want = ref_st_force_blocks(rx, s["ref"]["normals_s"], rrho, rmask, nbr,
                                   rparams, RefWendlandC2, 32, GAMMA,
                                   mimage=mimage)
        _planes_close(got, want, s["live"], pass_name)
    else:
        got = ops.energy_pairs_plain(*s["port"], *s["port"], grid, params,
                                     wrap_axes=wrap)
        want = ref_energy_blocks(rx, rv, rrho, rp, rmask, nbr, rparams,
                                 RefWendlandC2, 32, mimage=mimage)
        _scaled_close(got.numpy(), want, s["live"])


def test_plain_surface_tension_matches_reference(dense_case):
    """Normals then force, the composition the step runs, against the
    reference's ``_cohesion_blocks``."""
    s = dense_case
    x, _, rho, _, m = s["port"]
    rx, _, rrho, _, rmask, nbr = s["ref"]["args"]
    got = ops.surface_tension_plain(x, rho, m, s["grid"], s["params"], GAMMA,
                                    wrap_axes=s["wrap"])
    want = ref_cohesion_blocks(rx, rrho, rmask, nbr, s["ref"]["params"],
                               RefWendlandC2, 32, GAMMA,
                               mimage=s["ref"]["mimage"])
    _planes_close(got, want, s["live"], "surface tension")


# --------------------------------------------------------------------------
# the constants the CUDA kernels fold, replayed in float64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [WendlandC2, CubicSpline],
                         ids=["WendlandC2", "CubicSpline"])
def test_kernel_folds_reproduce_the_plain_pair_terms(kernel):
    """Each new pass's pair term as the CUDA kernel evaluates it (the
    folds of ``ops``, the weights in the kernel's own form: ``t^4 (4
    inv2h r + 1)`` and ``t^3`` or the cubic spline at sigma 1, the
    cohesion spline in units of ``hs^6``) against the plain pass's
    formula, in float64, on random pairs within the support."""
    params = SPHParams(mass=0.0137, h=0.031, dt=1e-4, alpha=0.3)
    rng = numpy.random.default_rng(1)
    n = 4096
    h, hs = params.h, kernel.support_scale * params.h
    dx = rng.standard_normal((n, 3))
    dx *= (hs * rng.uniform(0.0, 0.999, n) / numpy.linalg.norm(dx, axis=1))[:, None]
    r = numpy.linalg.norm(dx, axis=1)
    rho_i, rho_j = rng.uniform(900, 1100, n), rng.uniform(900, 1100, n)
    p_i, p_j = rng.uniform(-100, 5000, n), rng.uniform(-100, 5000, n)
    v_ij = rng.standard_normal((n, 3))
    n_i, n_j = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    rt = torch.from_numpy(r)
    w = kernel.w(rt, h, dim=params.dim).numpy()
    dwr = kernel.dw_over_r(rt, h, dim=params.dim).numpy()
    sigma = kernel._sigma(h, params.dim)
    inv2h = 0.5 / h
    t = numpy.maximum(1.0 - inv2h * r, 0.0)
    if kernel is WendlandC2:
        w_kernel, g = t**4 * (4.0 * inv2h * r + 1.0), t**3
    else:
        w_kernel = w / sigma  # cubic_w(r, h, 1)
        g = -dwr  # cubic_neg_dwr
    cfold, cv = ops._accel_folds(params, kernel)

    def close(got, want):
        numpy.testing.assert_allclose(got, want, rtol=1e-12,
                                      atol=1e-12 * numpy.abs(want).max())

    # XSPH: xfold W' / (rho_i + rho_j) (v_j - v_i), v_j - v_i = -v_ij
    got = ops._xsph_folds(params, kernel) * (w_kernel / (rho_i + rho_j))[:, None] * -v_ij
    close(got, (2 * params.mass / (rho_i + rho_j) * w)[:, None] * -v_ij)
    # normals: nfold g / rho_j x_ij
    got = ops._st_normals_folds(params, kernel) * (g / rho_j)[:, None] * dx
    close(got, hs * (params.mass / rho_j * dwr)[:, None] * dx)
    # force: kfold / (rho_i + rho_j) (cohfold F(u) / max(r) x_ij + n_ij)
    inv_hs, cohfold, kfold = ops._st_force_folds(params, kernel, GAMMA)
    u = r * inv_hs
    core = (numpy.maximum(1.0 - u, 0.0) * u) ** 3
    spline = numpy.where(u > 0.5, numpy.where(u <= 1.0, core, 0.0),
                         2.0 * core - 1.0 / 64.0)
    coh = cohfold * spline / numpy.maximum(r, 1e-12)
    got = (kfold / (rho_i + rho_j))[:, None] * (coh[:, None] * dx + (n_i - n_j))
    kij = 2 * params.rho0 / (rho_i + rho_j)
    c_r = _cohesion_c(rt, hs).numpy()
    want = (-GAMMA * kij)[:, None] * (
        (params.mass * c_r / numpy.maximum(r, 1e-12))[:, None] * dx + (n_i - n_j))
    close(got, want)
    # energy: -1/2 scale (v_ij . x_ij) with the acceleration's scale
    vdotx = numpy.sum(v_ij * dx, axis=1)
    h2eps = params.eps * h * h
    visc = cv * numpy.minimum(vdotx, 0.0) / ((r * r + h2eps) * (rho_i + rho_j))
    scale = (cfold * p_i / rho_i**2 + cfold * p_j / rho_j**2 + visc) * g
    pi = numpy.where(vdotx < 0.0, -params.alpha * params.c0 * h * vdotx
                     / (r * r + h2eps) / (0.5 * (rho_i + rho_j)), 0.0)
    press_pi = p_i / rho_i**2 + p_j / rho_j**2 + pi
    close(-0.5 * scale * vdotx, 0.5 * params.mass * press_pi * dwr * vdotx)


@pytest.mark.parametrize("periodic", [False, True], ids=["closed", "periodic"])
def test_energy_rate_matches_reference(periodic):
    db = ref_dam_break(n_side=8, capacity=72)
    x, v = _moving(numpy.asarray(db.state.x), db.params.h / 1.3, seed=4)
    want = ref_energy_rate(RefState(x=x, v=v), db.grid, db.params,
                           periodic=periodic)
    got = energy_rate(state_from_numpy(x, v, "cpu"), grid_from_reference(db.grid),
                      params_from_reference(db.params), periodic=periodic,
                      device="cpu")
    assert got.shape == (x.shape[0],) and got.dtype == torch.float32
    _scaled_close(got.numpy(), want, slice(None))


# --------------------------------------------------------------------------
# the reference's physical checks, on the port
# --------------------------------------------------------------------------


def _cube(seed=5):
    """``dam_break(n_side=8)`` filling a unit box, with N(0, 0.01)
    velocities; its density finished as the step finishes it."""
    db = dam_break(n_side=8, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0),
                   device="cpu")
    rng = numpy.random.RandomState(seed)
    v = torch.from_numpy(rng.randn(db.n, 3).astype(numpy.float32) * 0.1)
    x, grid, params = db.state.x, db.grid, db.params
    cells = build_cells(x, grid)
    assert int(cells.overflow) == 0
    c = grid.n_cells
    xv = scatter_to_cells_soa(torch.cat([x, v], 1), cells, grid)
    rho, _ = density_and_pressure(x, grid, params, device="cpu")
    rho_d = scatter_to_cells_soa(rho[:, None], cells, grid)[0]
    m = cells.mask[:c]
    rho_d = torch.where(m, rho_d, params.rho0)
    return db, v, cells, xv, rho_d, m


def _gathered(soa, cells, grid):
    """Per-slot ``[3, C, K]`` -> ``[N, 3]`` in particle order."""
    aos = soa.permute(1, 2, 0)
    return gather_from_cells(
        torch.cat([aos, aos.new_zeros((1,) + tuple(aos.shape[1:]))]), cells,
        grid).numpy()


def test_xsph_conserves_momentum():
    """The XSPH pair weight is symmetric and the velocity difference
    antisymmetric: the correction sums to ~0 (equal masses) and damps
    velocity disorder (tests/test_sph.py)."""
    db, v, cells, xv, rho, m = _cube()
    nbr = neighbor_index(db.grid, torch.device("cpu"))
    dv = _gathered(_xsph_blocks(xv[:3], xv[3:], rho, m, xv[:3], xv[3:], rho, m,
                                nbr, db.params, WendlandC2), cells, db.grid)
    total = numpy.abs(dv.sum(axis=0))
    scale = numpy.abs(v.numpy()).sum()
    assert (total < 1e-4 * scale).all(), (total, scale)
    before = numpy.var(v.numpy(), axis=0).sum()
    after = numpy.var(v.numpy() + 0.5 * dv, axis=0).sum()
    assert after < before


def test_surface_tension_conserves_momentum():
    """Both Akinci pair terms are antisymmetric: the surface-tension kicks
    sum to ~0 (tests/test_sph.py)."""
    db, _, cells, xv, rho, m = _cube()
    coh = _gathered(ops.surface_tension_plain(xv[:3], rho, m, db.grid,
                                              db.params, 1.0), cells, db.grid)
    total = numpy.abs(coh.sum(axis=0))
    scale = numpy.abs(coh).sum()
    assert scale > 0
    assert (total < 1e-4 * scale).all(), (total, scale)


def test_energy_rate_conserves_pair_energy():
    """``sum_i m du_i/dt == -sum_i m v_i . a_i`` for the pair forces
    (tests/test_sph.py): the energy pass is the momentum pass's
    conjugate."""
    rng = numpy.random.RandomState(3)
    n = 150
    x = torch.from_numpy(rng.rand(n, 3).astype(numpy.float32))
    v = torch.from_numpy(rng.randn(n, 3).astype(numpy.float32) * 0.2)
    h = 0.12
    params = SPHParams(mass=0.8, h=h, dt=1e-4, alpha=0.3)
    grid = make_grid((0, 0, 0), (1, 1, 1), support=2 * h, capacity=128)
    du = energy_rate(SPHState(x=x, v=v), grid, params, device="cpu").numpy()

    cells = build_cells(x, grid)
    assert int(cells.overflow) == 0
    c = grid.n_cells
    xv = scatter_to_cells_soa(torch.cat([x, v], 1), cells, grid)
    m = cells.mask[:c]
    nbr = neighbor_index(grid, torch.device("cpu"))
    rho, p = _finish(_density_blocks(xv[:3], m, xv[:3], m, nbr, params,
                                     WendlandC2), m, params)
    acc = _gathered(_accel_blocks(xv[:3], xv[3:], rho, p, m, xv[:3], xv[3:],
                                  rho, p, m, nbr, params, WendlandC2),
                    cells, grid)
    internal = params.mass * du.sum()
    kinetic = params.mass * (v.numpy() * acc).sum()
    scale = max(abs(internal), abs(kinetic), 1e-6)
    assert abs(internal + kinetic) / scale < 1e-3, (internal, kinetic)
    assert numpy.isfinite(du).all()


def test_surface_tension_contracts_free_drop():
    """A free cube with cohesion and no gravity contracts; without it, it
    does not as much (tests/test_sph.py: 60 steps)."""
    db = dam_break(n_side=6, box=(1.0, 1.0, 1.0), fill=(0.4, 0.4, 0.4),
                   device="cpu")
    x0 = db.state.x + torch.tensor([0.3, 0.3, 0.3])
    params = db.params._replace(gravity=(0.0, 0.0, 0.0))

    def rms_radius(x):
        x = x.numpy()
        return float(numpy.sqrt(((x - x.mean(axis=0)) ** 2).sum(1).mean()))

    def run(gamma):
        step = make_step_fn(db.grid, params, surface_tension=gamma,
                            device="cpu")
        s = SPHState(x=x0, v=torch.zeros_like(x0))
        for _ in range(60):
            s, (_, _, ov) = step(s)
            assert int(ov) == 0
        return s

    r0 = rms_radius(x0)
    s_coh = run(2.0)
    assert bool(torch.isfinite(s_coh.x).all())
    r_coh = rms_radius(s_coh.x)
    r_free = rms_radius(run(0.0).x)
    assert r_coh < r_free
    assert r_coh < r0


def test_continuity_composes_with_xsph_and_surface_tension():
    db = dam_break(n_side=5, device="cpu")
    step = make_step_fn(db.grid, db.params, density_mode="continuity",
                        xsph=0.5, surface_tension=0.5, device="cpu")
    s = init_density(db.state, db.grid, db.params, device="cpu")
    for _ in range(10):
        s, (rho, p, ov) = step(s)
    assert int(ov) == 0
    assert bool(torch.isfinite(s.x).all() and torch.isfinite(s.rho).all())


def test_cohesion_spline_matches_reference():
    hs = 0.07
    r = numpy.linspace(0.0, 1.2 * hs, 97).astype(numpy.float32)
    from tpgsd.sph.step import _cohesion_c as ref_cohesion_c

    want = numpy.asarray(ref_cohesion_c(jnp.asarray(r), hs))
    got = _cohesion_c(torch.from_numpy(r), hs).numpy()
    numpy.testing.assert_allclose(got, want, rtol=1e-6,
                                  atol=1e-6 * numpy.abs(want).max())
    assert math.isclose(float(got[0]), -32.0 / (math.pi * hs**3) / 64.0,
                        rel_tol=1e-5)
