"""The single-tier pair ops past 64 slots and the periodic boundaries of
the torch port against the JAX package: ``ops.density/accel/accel_drho``
(their plain versions: the tensors are on the CPU) at capacity 128 and 96
against the lane-padded Pallas kernels in interpret mode and the jnp pair
blocks; every entry point with ``wrap_axes`` (the ghost-cell halo) against
the jnp path's wrapped table and minimum image; the ghost maps; two steps
of the single-tier K = 128 step and of the periodic step in both density
modes; the scenario functions.  The hand-written wide kernels themselves
are held to the plain versions on the card by tests/test_torch_cuda.py.

Tolerances are the repo's Pallas-vs-jnp ones: density rtol 1e-5, atol
1e-6 and acceleration and drho/dt rtol 1e-4, atol 1e-5, on values scaled
by their max (the sums run in another order in each implementation);
drho/dt against the Pallas kernel atol 4e-3, which bounds the reference's
approximate reciprocals (ROADMAP "Faults found"); positions after two
steps rtol 1e-5, atol 1e-6.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph import pallas_ops
from tpgsd.sph import scenarios as ref_scenarios
from tpgsd.sph.cells import build_cells as ref_build_cells
from tpgsd.sph.cells import make_grid as ref_make_grid
from tpgsd.sph.cells import neighbor_table as ref_neighbor_table
from tpgsd.sph.cells import scatter_to_cells as ref_scatter_to_cells
from tpgsd.sph.kernels import WendlandC2
from tpgsd.sph.step import _accel_blocks as ref_accel_blocks
from tpgsd.sph.step import _accel_drho_blocks as ref_accel_drho_blocks
from tpgsd.sph.step import _density_blocks as ref_density_blocks
from tpgsd.sph.step import _mimage_of as ref_mimage_of
from tpgsd.sph.step import tait_pressure as ref_tait_pressure
from tpgsd_torch.sph import init_density, make_step_fn, ops
from tpgsd_torch.sph import scenarios as port_scenarios
from tpgsd_torch.sph.cells import (
    build_cells,
    build_cells_spill,
    scatter_to_cells_soa,
)
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    scenario_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.step import minimum_image, resolve_policy


def _scaled_close(got, want, live, rtol, atol):
    got, want = numpy.asarray(got)[live], numpy.asarray(want)[live]
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


def _reference_fields(x, v, grid, params, periodic=False):
    """The JAX package's single-tier layout of ``(x, v)`` with its jnp
    density, finished as the step finishes it, and the pair-block
    arguments ``(nbr, mimage)``."""
    cells = ref_build_cells(jnp.asarray(x), grid)
    dense = ref_scatter_to_cells(
        jnp.asarray(numpy.concatenate([x, v], axis=1)), cells, grid
    )
    nbr = ref_neighbor_table(grid, periodic=periodic)
    mim = ref_mimage_of(grid, periodic)
    rho0 = ref_density_blocks(
        dense[..., :3], cells.mask, nbr, params, WendlandC2, 8, mimage=mim
    )
    rho = jnp.concatenate(
        [rho0, jnp.full((1, grid.capacity), params.rho0, rho0.dtype)]
    )
    rho = jnp.where(cells.mask, jnp.maximum(rho, 0.1 * params.rho0), params.rho0)
    p = jnp.where(cells.mask, ref_tait_pressure(rho, params), 0.0)
    return cells, dense[..., :3], dense[..., 3:], rho0, rho, p, nbr, mim


def _port_tier(x, v, rho, p, grid_r):
    """The port's single tier ``(x, v, rho, p, mask)`` of the same input,
    carrying the reference's finished density and pressure."""
    grid = grid_from_reference(grid_r)
    c = grid.n_cells
    cells = build_cells(torch.from_numpy(x), grid)
    soa = scatter_to_cells_soa(
        torch.from_numpy(numpy.concatenate([x, v], axis=1)), cells, grid
    )
    return grid, (
        soa[:3], soa[3:], torch.from_numpy(numpy.array(rho[:c])),
        torch.from_numpy(numpy.array(p[:c])), cells.mask,
    )


def _dam_break_case(capacity, moving):
    """``dam_break(n_side=6)`` (the grid of tests/test_pallas_ops.py), at
    rest or with N(0, 0.1) velocities."""
    db = ref_dam_break(n_side=6, capacity=capacity)
    x = numpy.asarray(db.state.x)
    v = numpy.zeros_like(x)
    if moving:
        v = (numpy.random.RandomState(2).randn(*x.shape) * 0.1).astype(numpy.float32)
    return db, x, v


# --------------------------------------------------------------------------
# the single-tier entry points past 64 slots
# --------------------------------------------------------------------------


@pytest.mark.parametrize("moving", [False, True], ids=["at_rest", "moving"])
@pytest.mark.parametrize("capacity", [96, 128])
def test_single_tier_ops_match_jnp_blocks(capacity, moving):
    """``ops.density``, ``accel`` and ``accel_drho`` (delta-SPH on and off)
    against ``_density_blocks``, ``_accel_blocks`` and
    ``_accel_drho_blocks`` of the JAX package (at rest drho/dt is the
    diffusion term alone)."""
    db, x, v = _dam_break_case(capacity, moving)
    cells_r, dx, dv, rho0, rho, p, nbr, _ = _reference_fields(
        x, v, db.grid, db.params
    )
    grid, tier = _port_tier(x, v, rho, p, db.grid)
    params = params_from_reference(db.params)
    c = grid.n_cells
    live = tier[4][:c].numpy()
    assert (live == numpy.asarray(cells_r.mask)[:c]).all()

    # the larger case also holds the plain versions and delta-SPH off
    extra = capacity == 96 and moving

    got = ops.density(tier[0], tier[4], grid, params)
    assert got.shape == (c, capacity) and not bool(got[~tier[4][:c]].any())
    _scaled_close(got, rho0, live, 1e-5, 1e-6)
    if extra:
        assert torch.equal(
            got, ops.density_plain(tier[0], tier[4], grid, params))

    want = numpy.asarray(
        ref_accel_blocks(dx, dv, rho, p, cells_r.mask, nbr, db.params,
                         WendlandC2, 32)
    )
    got = ops.accel(*tier, grid, params)
    assert got.shape == (3, c, capacity)
    for col in range(3):
        _scaled_close(got[col], want[..., col], live, 1e-4, 1e-5)
    if extra:
        assert torch.equal(got, ops.accel_plain(*tier, grid, params))

    for delta in (0.1, 0.0) if extra else (0.1,):
        want = numpy.asarray(
            ref_accel_drho_blocks(dx, dv, rho, p, cells_r.mask, nbr,
                                  db.params, WendlandC2, 32, delta)
        )
        got = ops.accel_drho(*tier, grid, params, delta_sph=delta)
        assert got.shape == (4, c, capacity)
        assert numpy.abs(want[..., 3]).max() > 0
        for col in range(4):
            _scaled_close(got[col], want[..., col], live, 1e-4, 1e-5)
    if extra:
        assert torch.equal(
            got, ops.accel_drho_plain(*tier, grid, params, delta_sph=0.0)
        )


@pytest.fixture(scope="module")
def lane_native_case():
    """K = 128 at rest: the input, the port's tier, and what the three
    lane-padded Pallas kernels (interpret mode) make of it."""
    db, x, v = _dam_break_case(128, False)
    cells_r, dx, dv, _, rho, p, _, _ = _reference_fields(x, v, db.grid, db.params)
    grid, tier = _port_tier(x, v, rho, p, db.grid)
    assert not pallas_ops._use_packed(db.grid)
    kw = {"kernel": WendlandC2, "interpret": True}
    return {
        "grid": grid, "params": params_from_reference(db.params),
        "tier": tier, "live": tier[4][: grid.n_cells].numpy(),
        "density": numpy.asarray(
            pallas_ops.density(dx, cells_r.mask, db.grid, db.params, **kw)),
        "accel": numpy.asarray(
            pallas_ops.accel(dx, dv, rho, p, cells_r.mask, db.grid,
                             db.params, **kw)),
        "accel_drho": numpy.asarray(
            pallas_ops.accel_drho(dx, dv, rho, p, cells_r.mask, db.grid,
                                  db.params, delta_sph=0.1, **kw)),
    }


def test_density_matches_lane_padded_pallas_kernel(lane_native_case):
    s = lane_native_case
    got = ops.density(s["tier"][0], s["tier"][4], s["grid"], s["params"])
    _scaled_close(got, s["density"], s["live"], 1e-5, 1e-6)


def test_accel_matches_lane_padded_pallas_kernel(lane_native_case):
    s = lane_native_case
    got = ops.accel(*s["tier"], s["grid"], s["params"])
    for col in range(3):
        _scaled_close(got[col], s["accel"][..., col], s["live"], 1e-4, 1e-5)


def test_accel_drho_matches_lane_padded_pallas_kernel(lane_native_case):
    """Acceleration columns at the acceleration tolerance; drho/dt (pure
    diffusion at rest) at atol 4e-3, the reference kernel's own error."""
    s = lane_native_case
    got = ops.accel_drho(*s["tier"], s["grid"], s["params"], delta_sph=0.1)
    want = s["accel_drho"]
    for col in range(3):
        _scaled_close(got[col], want[..., col], s["live"], 1e-4, 1e-5)
    assert numpy.abs(want[..., 3][s["live"]]).max() > 0
    _scaled_close(got[3], want[..., 3], s["live"], 1e-4, 4e-3)


# --------------------------------------------------------------------------
# periodic axes: the ghost-cell halo
# --------------------------------------------------------------------------


def _periodic_case(capacity):
    """The cloud of tests/test_pallas_ops.py::test_periodic_matches_jnp:
    250 random particles in a 1.2 x 1.0 x 0.9 box of 4 x 3 x 3 cells."""
    rng = numpy.random.RandomState(3)
    grid_r = ref_make_grid((0, 0, 0), (1.2, 1.0, 0.9), 0.3, capacity=capacity)
    x = (rng.rand(250, 3).astype(numpy.float32)
         * numpy.array([1.2, 1.0, 0.9], numpy.float32))
    v = (rng.randn(250, 3) * 0.1).astype(numpy.float32)
    return grid_r, x, v, RefParams(mass=0.01, h=0.15, dt=1e-4)


@pytest.mark.parametrize("wrap", [(True, True, True), (True, False, True)],
                         ids=["all_axes", "xz"])
def test_ghost_maps_match_reference(wrap):
    grid_r = ref_make_grid((0, 0, 0), (1.2, 1.0, 0.9), 0.3, capacity=48)
    want = pallas_ops._ghost_maps(grid_r, wrap)
    got = ops._ghost_maps(grid_from_reference(grid_r), wrap)
    assert tuple(got[0]) == tuple(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        numpy.testing.assert_array_equal(g, w)
    g, src, shift, interior = ops._ghost_index(
        grid_from_reference(grid_r), wrap, torch.device("cpu")
    )
    assert src.dtype == interior.dtype == torch.int64
    assert shift.shape == (3, g.n_cells, 1)
    numpy.testing.assert_array_equal(shift[:, :, 0].numpy().T, want[2])


@pytest.mark.parametrize("capacity", [48, 128])
def test_periodic_single_tier_ops_match_jnp(capacity):
    """``wrap_axes`` on the single-tier entry points (ghost halo, then the
    plain pass on the ghost grid) and on their plain versions (wrapped
    table + minimum image) against the jnp path; a wrapped pass differs
    from the closed one."""
    grid_r, x, v, params_r = _periodic_case(capacity)
    wrap = tuple(bool(d >= 3) for d in grid_r.dims)
    assert all(wrap)
    cells_r, dx, dv, rho0, rho, p, nbr, mim = _reference_fields(
        x, v, grid_r, params_r, periodic=True
    )
    grid, tier = _port_tier(x, v, rho, p, grid_r)
    params = params_from_reference(params_r)
    live = tier[4][: grid.n_cells].numpy()
    numpy.testing.assert_array_equal(
        minimum_image(grid, torch.device("cpu"), True).numpy().ravel(), mim
    )

    # the ghost grid has 6 x 5 x 5 cells: at 128 slots the plain pass on
    # it is slow on the CPU, so the wrapped-table versions run at 48 only
    both = capacity == 48
    for fn in (ops.density, ops.density_plain) if both else (ops.density,):
        got = fn(tier[0], tier[4], grid, params, wrap_axes=wrap)
        _scaled_close(got, rho0, live, 1e-5, 1e-6)
    if both:
        closed = ops.density(tier[0], tier[4], grid, params)
        assert float((closed - got).abs().max()) > 1e-2 * float(got.max())

    # (at 128 the acceleration is held as the first three columns of the
    # fused pass)
    want = numpy.asarray(
        ref_accel_blocks(dx, dv, rho, p, cells_r.mask, nbr, params_r,
                         WendlandC2, 8, mimage=mim)
    ) if both else None
    for fn in (ops.accel, ops.accel_plain) if both else ():
        got = fn(*tier, grid, params, wrap_axes=wrap)
        for col in range(3):
            _scaled_close(got[col], want[..., col], live, 1e-4, 1e-5)

    want = numpy.asarray(
        ref_accel_drho_blocks(dx, dv, rho, p, cells_r.mask, nbr, params_r,
                              WendlandC2, 8, 0.1, mimage=mim)
    )
    for fn in (ops.accel_drho, ops.accel_drho_plain) if both else (ops.accel_drho,):
        got = fn(*tier, grid, params, delta_sph=0.1, wrap_axes=wrap)
        for col in range(4):
            _scaled_close(got[col], want[..., col], live, 1e-4, 1e-5)


def test_periodic_spill_ops_match_jnp():
    """The three two-tier entry points with ``wrap_axes`` at K = 8 + 8
    (the densest cell holds 12 particles, so the spill tier is occupied)
    against the jnp path on the slot-identical single tier of 16 slots."""
    k = 8
    grid_r, x, v, params_r = _periodic_case(2 * k)
    wrap = (True, True, True)
    cells_r, dx, dv, rho0, rho, p, nbr, mim = _reference_fields(
        x, v, grid_r, params_r, periodic=True
    )
    grid = grid_from_reference(grid_r)._replace(capacity=k)
    params = params_from_reference(params_r)
    c = grid.n_cells
    cells, sp = build_cells_spill(torch.from_numpy(x), grid, k)
    assert bool(sp.mask.any()) and int(cells.overflow) == 0
    xv = torch.from_numpy(numpy.concatenate([x, v], axis=1))
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    live = (cells.mask[:c].numpy(), sp.mask[:c].numpy())
    rho_t, p_t = (torch.from_numpy(numpy.array(f[:c])) for f in (rho, p))
    ta = (a[:3], a[3:], rho_t[:, :k].contiguous(), p_t[:, :k].contiguous(),
          cells.mask)
    tb = (b[:3], b[3:], rho_t[:, k:].contiguous(), p_t[:, k:].contiguous(),
          sp.mask)

    def tiers(want):  # [C, 2K, ...] -> the two tiers' slots
        return want[:, :k], want[:, k:]

    for fn in (ops.density_spill, ops.density_spill_plain):
        got = fn(ta[0], ta[4], tb[0], tb[4], grid, params, wrap_axes=wrap)
        for t, want in enumerate(tiers(numpy.asarray(rho0))):
            _scaled_close(got[t], want, live[t], 1e-5, 1e-6)
    want3 = numpy.asarray(
        ref_accel_blocks(dx, dv, rho, p, cells_r.mask, nbr, params_r,
                         WendlandC2, 8, mimage=mim)
    )
    want4 = numpy.asarray(
        ref_accel_drho_blocks(dx, dv, rho, p, cells_r.mask, nbr, params_r,
                              WendlandC2, 8, 0.1, mimage=mim)
    )
    for fn, want in (
        (ops.accel_spill, want3), (ops.accel_spill_plain, want3),
        (ops.accel_drho_spill, want4), (ops.accel_drho_spill_plain, want4),
    ):
        got = fn(*ta, *tb, grid, params, wrap_axes=wrap)
        for t, w in enumerate(tiers(want)):
            assert got[t].shape == w.shape
            for col in range(w.shape[-1]):
                _scaled_close(got[t][..., col], w[..., col], live[t], 1e-4, 1e-5)


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------


def _two_steps(step_ref, step, state_r, state):
    for _ in range(2):
        state_r, (rho_r, p_r, ov_r) = step_ref(state_r)
        state, (rho, p, ov) = step(state)
        assert int(ov) == int(ov_r) == 0
    numpy.testing.assert_allclose(
        state.x.numpy(), numpy.asarray(state_r.x), rtol=1e-5, atol=1e-6
    )
    everything = numpy.ones(rho.shape, bool)
    _scaled_close(state.v.numpy(), state_r.v, numpy.ones(state.v.shape, bool),
                  1e-4, 1e-5)
    return state_r, state, rho_r, rho, everything


@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
def test_single_tier_k128_step_matches_reference(density_mode):
    """Two steps of the single-tier K = 128 step against the JAX step on
    the jnp path (the lane-padded Pallas kernels are held to the ops one
    by one above; their factorised reduction costs the velocities up to
    3.9e-5 of their max, ROADMAP "Faults found")."""
    db, x, v = _dam_break_case(128, True)
    step_ref = jax.jit(ref_make_step_fn(
        db.grid, db.params, use_pallas=False, density_mode=density_mode,
    ))
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    step = make_step_fn(grid, params, density_mode=density_mode, device="cpu")
    assert step.resolved == {
        "use_kernels": False, "spill": False, "density_mode": density_mode
    }
    state_r, state = RefState(x=x, v=v), state_from_numpy(x, v, "cpu")
    if density_mode == "continuity":
        state_r = ref_init_density(state_r, db.grid, db.params)
        state = init_density(state, grid, params, device="cpu")
        numpy.testing.assert_allclose(
            state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-5
        )
    state_r, state, rho_r, rho, everything = _two_steps(
        step_ref, step, state_r, state
    )
    if density_mode == "continuity":
        numpy.testing.assert_allclose(
            state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-4, atol=1e-2
        )
    else:
        _scaled_close(rho.numpy(), rho_r, everything, 1e-5, 1e-6)


@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single_tier", "spill"])
def test_periodic_step_matches_reference(spill, density_mode):
    """Two periodic steps on the cloud of _periodic_case against the JAX
    step on the jnp path: the single tier of 16 slots (wrapped table +
    minimum image), and the two-tier layout at K = 8 + 8, slot-identical
    to it (wrapped table in the plain spill ops).  Particles cross the
    seam: the wrap of the positions is exercised."""
    grid_r, x, v, params_r = _periodic_case(16)
    v = 100.0 * v  # |v| dt of the order of 1e-2: some particles cross a face
    params_r = params_r._replace(dt=1e-3, gravity=(0.0, 0.0, 0.0))
    step_ref = jax.jit(ref_make_step_fn(
        grid_r, params_r, use_pallas=False, periodic=True,
        density_mode=density_mode,
    ))
    grid, params = grid_from_reference(grid_r), params_from_reference(params_r)
    step = make_step_fn(
        grid._replace(capacity=8) if spill else grid, params, spill=spill,
        periodic=True, density_mode=density_mode, device="cpu",
    )
    state_r, state = RefState(x=x, v=v), state_from_numpy(x, v, "cpu")
    if density_mode == "continuity":
        state_r = ref_init_density(state_r, grid_r, params_r, periodic=True)
        state = init_density(state, grid, params, periodic=True, device="cpu")
        numpy.testing.assert_allclose(
            state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-5
        )
    state_r, state, rho_r, rho, everything = _two_steps(
        step_ref, step, state_r, state
    )
    moved = numpy.abs(state.x.numpy() - x)
    assert (moved > 0.5).any(), "no particle crossed a periodic face"
    if density_mode == "continuity":
        numpy.testing.assert_allclose(
            state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-4, atol=1e-2
        )
    else:
        _scaled_close(rho.numpy(), rho_r, everything, 1e-5, 1e-6)


def test_policy_past_64_slots_is_the_single_tier():
    grid = grid_from_reference(ref_dam_break(n_side=6, capacity=128).grid)
    assert resolve_policy("cuda", grid) == (True, False)
    assert resolve_policy("cuda", grid, True, False) == (True, False)
    assert resolve_policy("cuda", grid._replace(capacity=64)) == (True, True)
    with pytest.raises(ValueError, match="capacity <= 64; got 128"):
        resolve_policy("cuda", grid, "auto", True)
    # without the kernels the plain spill ops take any capacity
    assert resolve_policy("cuda", grid, False, True) == (False, True)
    assert resolve_policy("cpu", grid) == (False, False)


# --------------------------------------------------------------------------
# the scenario functions
# --------------------------------------------------------------------------

_SCENARIOS = {
    "hydrostatic_tank": {"n_side": 6},
    "still_box": {"n_side": 6, "capacity": "auto"},
    "dam_break_2d": {"n_side": 10, "capacity": "auto"},
    "still_box_2d": {"n_side": 12},
    "taylor_green": {"n_side": 16, "capacity": "auto"},
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_scenario_matches_reference(name):
    """Bit-identical initial state, grid and parameters."""
    kw = _SCENARIOS[name]
    want = getattr(ref_scenarios, name)(**kw)
    got = getattr(port_scenarios, name)(device="cpu", **kw)
    for field in ("x", "v"):
        g = getattr(got.state, field)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        numpy.testing.assert_array_equal(
            g.numpy(), numpy.asarray(getattr(want.state, field))
        )
    assert got.state.rho is None
    assert tuple(got.grid) == tuple(want.grid)
    assert tuple(got.params) == tuple(want.params)
    assert (got.box, got.n, got.n_fixed) == (want.box, want.n, want.n_fixed)
    carried = scenario_from_reference(want, "cpu")
    assert carried.grid == got.grid and carried.params == got.params
    assert torch.equal(carried.state.x, got.state.x)
    assert torch.equal(carried.state.v, got.state.v)
    assert (carried.box, carried.n, carried.n_fixed) == (got.box, got.n, got.n_fixed)


def test_taylor_green_runs_in_both_packages():
    """One scenario built once and stepped by both packages: two periodic
    2-D steps; z never moves (tests/test_scenarios.py holds the JAX step
    to this)."""
    sc = ref_scenarios.taylor_green(n_side=16)
    port = scenario_from_reference(sc, "cpu")
    step_ref = jax.jit(ref_make_step_fn(
        sc.grid, sc.params, use_pallas=False, periodic=True
    ))
    step = make_step_fn(port.grid, port.params, periodic=True, device="cpu")
    state_r, state, rho_r, rho, everything = _two_steps(
        step_ref, step, RefState(x=sc.state.x, v=sc.state.v), port.state
    )
    _scaled_close(rho.numpy(), rho_r, everything, 1e-5, 1e-6)
    assert torch.equal(state.x[:, 2], port.state.x[:, 2])
    # no wall deficit: density holds near rho0 everywhere
    assert float((rho / sc.params.rho0 - 1.0).abs().max()) < 0.05
