"""The torch port's 3-D block decomposition
(``tpgsd_torch.sph.distributed3d``) against the JAX package's
(``tpgsd.sph.distributed3d``, its jnp path on the suite's 8 virtual CPU
devices), one test for each case of tests/test_distributed3d.py.

Both packages get the same inputs: the reference's random cloud (160
particles on a (4, 4, 4) unit box, ``numpy.random.RandomState(seed)``),
the state carried over by ``tpgsd_torch.sph.convert``; the port's mesh
is ``make_mesh3d(shape, devices=["cpu"] * n)`` at the reference's shape.
The per-shard ``pid`` arrays are equal at every step, the overflow
counts equal, and positions, density and velocities within the one-step
tolerances.  The reference's Pallas cases are mirrored by the port's
plain two-tier spill layout against the jnp path.  The degenerate meshes
are held against the port's own slab and 2-D steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from tpgsd.parallel import make_mesh3d as ref_make_mesh3d
from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph.cells import CellGrid as RefGrid
from tpgsd.sph.distributed3d import distribute_state_3d as ref_distribute
from tpgsd.sph.distributed3d import (
    make_adaptive_distributed3d_step_fn as ref_make_adaptive,
)
from tpgsd.sph.distributed3d import make_distributed3d_step_fn as ref_make_step
from tpgsd_torch.parallel import make_mesh, make_mesh2d, make_mesh3d
from tpgsd_torch.sph import (
    collect_state,
    distribute_state,
    distribute_state_2d,
    distribute_state_3d,
    make_adaptive_distributed3d_step_fn,
    make_distributed2d_step_fn,
    make_distributed3d_step_fn,
    make_distributed_step_fn,
)
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.distributed import concat_shards

CPU = "cpu"
X_TOL = dict(rtol=1e-5, atol=1e-6)
RHO_RTOL = 1e-5
V_TOL = dict(rtol=1e-4, atol=1e-5)  # on v scaled by its max
#: the reference's degenerate-mesh tolerances
#: (tests/test_distributed3d.py:200-265)
DEGENERATE_X = dict(rtol=1e-5, atol=1e-6)
DEGENERATE_V = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud_params():
    return RefParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                     gravity=(0.0, 0.0, -9.81))


@functools.lru_cache(maxsize=None)
def _inputs(kind, seed=0, vscale=0.05, continuity=False):
    """``(ref grid, ref params, x, v, rho)``: ``"cloud"``, the
    reference's unit-box cloud (tests/test_distributed3d.py:32-44), the
    long ``"cloud8"`` of its degenerate cases (x over (8, 4, 4) cells),
    or ``"movers"``, the cloud with its first particle 3 mm from the
    blocks' common corner on each axis, moving across it to the opposite
    block of the (2, 2, 2) mesh.  ``continuity`` seeds rho with the
    reference's summation density."""
    long = kind == "cloud8"
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25,
                   dims=(8, 4, 4) if long else (4, 4, 4), capacity=16)
    rng = numpy.random.RandomState(seed)
    x = rng.uniform(0.05, 0.95, (160, 3)).astype(numpy.float32)
    if long:
        x[:, 0] *= 2.0
    v = (rng.randn(160, 3) * vscale).astype(numpy.float32)
    params = _cloud_params()
    if kind == "movers":
        x[0] = 0.5 - 0.003
        v[0] = vscale
    rho = None
    if continuity:
        st = ref_init_density(RefState(x=jnp.asarray(x), v=jnp.asarray(v)),
                              grid, params)
        rho = numpy.asarray(st.rho)
    return grid, params, x, v, rho


def _port_state(x, v, rho=None):
    return state_from_numpy(x, v, CPU, rho=rho)


def _ref_state(x, v, rho=None):
    return RefState(x=jnp.asarray(x), v=jnp.asarray(v),
                    rho=None if rho is None else jnp.asarray(rho))


def _np(t):
    return t.detach().cpu().numpy()


def _pids(dist):
    return numpy.concatenate([_np(p) for p in dist.pid])


def _cat(ts):
    return numpy.concatenate([_np(t) for t in ts])


def _mode(continuity):
    return "continuity" if continuity else "summation"


def _devices(shape):
    return [CPU] * int(numpy.prod(shape))


@functools.lru_cache(maxsize=None)
def _ref_run(kind, shape, n_steps, continuity=False, vscale=0.05, seed=0,
             periodic=False, items=()):
    grid, params, x, v, rho = _inputs(kind, seed, vscale, continuity)
    mesh = ref_make_mesh3d(shape=shape)
    dist, cap = ref_distribute(_ref_state(x, v, rho), grid, mesh)
    step = ref_make_step(grid, params, mesh, capacity=cap, use_pallas=False,
                         periodic=periodic, density_mode=_mode(continuity),
                         **dict(items))
    n_sh = int(numpy.prod(shape))
    snaps = []
    for _ in range(n_steps):
        dist, aux = step(dist)
        snaps.append(tuple(
            numpy.split(numpy.asarray(a), n_sh)
            for a in (dist.x, dist.v, dist.pid, aux.rho, aux.cell_overflow,
                      aux.migrate_overflow, aux.dudt)))
    return snaps, cap


def _port_run(kind, shape, n_steps, continuity=False, vscale=0.05, seed=0,
              periodic=False, items=(), spill=False):
    grid, params, x, v, rho = _inputs(kind, seed, vscale, continuity)
    pgrid = grid_from_reference(grid)
    if spill:
        pgrid = pgrid._replace(capacity=grid.capacity // 2)
    mesh = make_mesh3d(shape=shape, devices=_devices(shape))
    dist, cap = distribute_state_3d(_port_state(x, v, rho), pgrid, mesh)
    step = make_distributed3d_step_fn(
        pgrid, params_from_reference(params), mesh, capacity=cap,
        use_kernels=False, spill=spill, periodic=periodic,
        density_mode=_mode(continuity), **dict(items))
    assert step.resolved == {"use_kernels": False, "spill": spill,
                             "density_mode": _mode(continuity)}
    out = [(dist, None)]
    for _ in range(n_steps):
        dist, aux = step(dist)
        out.append((dist, aux))
    return out, cap, x.shape[0]


def hold_run(kind, shape, n_steps=3, continuity=False, vscale=0.05, seed=0,
             periodic=False, items=(), spill=False, dudt=False):
    """Both packages' 3-D steps, held step by step; returns the port's
    states (the first the distributed input) and the particle count."""
    snaps, cap = _ref_run(kind, shape, n_steps, continuity, vscale, seed,
                          periodic, items)
    out, cap_p, n = _port_run(kind, shape, n_steps, continuity, vscale, seed,
                              periodic, items, spill)
    assert cap_p == cap
    for i, (snap, (dist, aux)) in enumerate(zip(snaps, out[1:])):
        rx, rv, rpid, rrho, rcov, rmov, rdu = snap
        for d in range(len(rx)):
            numpy.testing.assert_array_equal(
                _np(dist.pid[d]), rpid[d],
                err_msg="step %d shard %d pid" % (i, d))
        assert [int(c) for c in aux.cell_overflow] == [int(c[0])
                                                       for c in rcov]
        assert [int(c) for c in aux.migrate_overflow] == [int(c[0])
                                                          for c in rmov]
        live = numpy.concatenate(rpid) >= 0
        cat = numpy.concatenate
        numpy.testing.assert_allclose(_cat(dist.x), cat(rx), **X_TOL,
                                      err_msg="step %d x" % i)
        numpy.testing.assert_allclose(_cat(aux.rho)[live], cat(rrho)[live],
                                      rtol=RHO_RTOL,
                                      err_msg="step %d rho" % i)
        vr = cat(rv)
        scale = numpy.abs(vr).max()
        numpy.testing.assert_allclose(_cat(dist.v) / scale, vr / scale,
                                      **V_TOL, err_msg="step %d v" % i)
        if dudt:
            dr = cat(rdu)[live]
            du_scale = numpy.abs(dr).max()
            assert du_scale > 0
            numpy.testing.assert_allclose(_cat(aux.dudt)[live] / du_scale,
                                          dr / du_scale, rtol=1e-4,
                                          atol=1e-5)
    return out, n


# --------------------------------------------------------------------------
# the mesh and the guards
# --------------------------------------------------------------------------


def test_mesh3d_shape_and_device_order():
    """The reference's most-cubic default, block (i, j, k) on shard (i *
    py + j) * pz + k."""
    mesh = make_mesh3d(devices=["cpu:%d" % i for i in range(8)])
    assert mesh.shape == (2, 2, 2)
    assert mesh.devices[(1 * 2 + 0) * 2 + 1] == torch.device("cpu", 5)
    assert make_mesh3d(devices=[CPU] * 12).shape == (3, 2, 2)
    assert make_mesh3d(shape=(4, 2, 1), devices=[CPU] * 9).size == 8
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        make_mesh3d(shape=(2, 2, 2), devices=[CPU] * 4)


def test_guards():
    grid, params, x, v, _rho = _inputs("cloud")
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh3d(shape=(2, 2, 2), devices=_devices((2, 2, 2)))
    with pytest.raises(ValueError, match="multiples of the mesh"):
        make_distributed3d_step_fn(pgrid._replace(dims=(4, 4, 3)), pparams,
                                   mesh, capacity=64)
    with pytest.raises(ValueError, match="3-D mesh"):
        make_distributed3d_step_fn(pgrid, pparams,
                                   make_mesh2d(shape=(2, 2),
                                               devices=[CPU] * 4),
                                   capacity=64)
    with pytest.raises(ValueError, match="3 cells along x, y and z"):
        make_distributed3d_step_fn(pgrid._replace(dims=(4, 4, 2)), pparams,
                                   mesh, capacity=64, periodic=True)
    with pytest.raises(ValueError, match="density_renorm"):
        make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=64,
                                   density_mode="continuity",
                                   density_renorm=True)
    dist, cap = distribute_state_3d(_port_state(x, v), pgrid, mesh)
    step = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                      density_mode="continuity")
    with pytest.raises(ValueError, match="distribute_state_3d"):
        step(dist)
    with pytest.raises(ValueError, match="3-D mesh"):
        distribute_state_3d(_port_state(x, v), pgrid,
                            make_mesh(devices=[CPU] * 2))


# --------------------------------------------------------------------------
# the step against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_3d_matches_reference(continuity, spill):
    """3 steps on the (2, 2, 2) mesh (the reference's test_3d_matches_
    single_device, test_3d_continuity_matches_single_device and, with
    ``spill``, its Pallas cases)."""
    out, n = hold_run("cloud", (2, 2, 2), continuity=continuity, spill=spill)
    pid = _pids(out[-1][0])
    assert sorted(pid[pid >= 0].tolist()) == list(range(n))


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_3d_periodic_matches_reference(continuity, spill):
    """The periodic cloud on the (2, 2, 2) mesh: every axis through its
    ring, faces, edges and corners of the seams (the reference's
    periodic cases, with ``spill`` its test_3d_periodic_pallas_matches_
    jnp)."""
    hold_run("cloud", (2, 2, 2), continuity=continuity, seed=4,
             periodic=True, spill=spill)


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_3d_migration_across_every_face_matches_reference(continuity):
    """The cloud at 10 m/s with a corner mover: particles cross faces of
    each axis, and the mover takes all three hops in one step."""
    out, n = hold_run("movers", (2, 2, 2), n_steps=2, continuity=continuity,
                      vscale=10.0, seed=1, spill=not continuity)
    owner = []
    for dist, _aux in (out[0], out[-1]):
        pid = _pids(dist)
        shard = numpy.repeat(numpy.arange(8), dist.pid[0].shape[0])
        own = numpy.full(n, -1)
        own[pid[pid >= 0]] = shard[pid >= 0]
        owner.append(numpy.stack(numpy.unravel_index(own, (2, 2, 2))))
    moved = owner[0] != owner[1]  # [3, n]
    for axis in range(3):
        assert (moved[axis] & (moved.sum(0) == 1)).any(), axis
    assert moved[:, 0].all()  # the corner mover
    assert sorted(_pids(out[-1][0])[_pids(out[-1][0]) >= 0].tolist()) == list(
        range(n))


def _isolated(x, v, grid, params, rho=None, **kw):
    x = numpy.asarray(x, numpy.float32)
    v = numpy.asarray(v, numpy.float32)
    mesh = make_mesh3d(shape=(2, 2, 2), devices=_devices((2, 2, 2)))
    dist, _ = distribute_state_3d(_port_state(x, v, rho),
                                  grid_from_reference(grid), mesh, capacity=8)
    step = make_distributed3d_step_fn(grid_from_reference(grid),
                                      params_from_reference(params), mesh,
                                      capacity=8, **kw)
    rmesh = ref_make_mesh3d(shape=(2, 2, 2))
    rdist, _ = ref_distribute(_ref_state(x, v, rho), grid, rmesh, capacity=8)
    rstep = ref_make_step(grid, params, rmesh, capacity=8, **kw)
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    return dist


def test_3d_migration_xyz_and_corner():
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.5, dims=(4, 4, 4),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.1, dt=0.1, gravity=(0.0, 0.0, 0.0))
    x = [[0.95, 0.25, 0.20], [0.30, 0.95, 0.60], [0.60, 0.25, 0.95],
         [0.98, 0.98, 0.98]]
    v = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0]]
    dist = _isolated(x, v, grid, params)
    numpy.testing.assert_allclose(
        collect_state(dist, 4).x,
        numpy.asarray(x) + 0.1 * numpy.asarray(v), rtol=1e-5)
    assert 3 in _np(dist.pid[7]).tolist()


def test_3d_continuity_corner_migration_carries_density():
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 8, 8),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.12, dt=0.1, gravity=(0.0, 0.0, 0.0))
    dist = _isolated([[0.95, 0.95, 0.95]], [[1.0, 1.0, 1.0]], grid, params,
                     rho=numpy.asarray([1212.25], numpy.float32),
                     density_mode="continuity", delta_sph=0.0)
    got = collect_state(dist, 1)
    numpy.testing.assert_allclose(got.x[0], [1.05, 1.05, 1.05], rtol=1e-5)
    numpy.testing.assert_array_equal(got.rho,
                                     numpy.asarray([1212.25], numpy.float32))


def test_3d_periodic_corner_wrap():
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(4, 4, 4),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.05, dt=0.1, gravity=(0.0, 0.0, 0.0))
    dist = _isolated([[0.04, 0.06, 0.08], [0.5, 0.5, 0.5]],
                     [[-1.0, -1.0, -1.0], [0.0, 0.0, 0.0]], grid, params,
                     periodic=True)
    numpy.testing.assert_allclose(collect_state(dist, 2).x[0],
                                  [0.94, 0.96, 0.98], rtol=1e-5)
    assert 0 in _np(dist.pid[7]).tolist()


# --------------------------------------------------------------------------
# degenerate meshes
# --------------------------------------------------------------------------


def _degenerate(make_a, make_b, seed, continuity=False):
    """Both steps 3 times from the long cloud (``make_*(pgrid, pparams,
    state, mode, cap) -> (dist, step, cap)``), the pid arrays equal."""
    grid, params, x, v, rho = _inputs("cloud8", seed, continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = _mode(continuity)
    da, sa, cap = make_a(pgrid, pparams, _port_state(x, v, rho), mode, None)
    db, sb, _ = make_b(pgrid, pparams, _port_state(x, v, rho), mode, cap)
    for _ in range(3):
        da, _aux_a = sa(da)
        db, aux_b = sb(db)
        numpy.testing.assert_array_equal(_pids(db), _pids(da))
    assert sum(int(c) for c in aux_b.migrate_overflow) == 0
    ga, gb = collect_state(da, x.shape[0]), collect_state(db, x.shape[0])
    numpy.testing.assert_allclose(gb.x, ga.x, **DEGENERATE_X)
    numpy.testing.assert_allclose(gb.v, ga.v, **DEGENERATE_V)
    if continuity:
        numpy.testing.assert_allclose(gb.rho, ga.rho, rtol=1e-5)


def _slab8(pgrid, pparams, state, mode, cap):
    mesh = make_mesh(devices=[CPU] * 8)
    dist, cap = distribute_state(state, pgrid, mesh, capacity=cap)
    return dist, make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap,
                                          density_mode=mode), cap


def _block2d(pgrid, pparams, state, mode, cap):
    mesh = make_mesh2d(shape=(4, 2), devices=[CPU] * 8)
    dist, cap = distribute_state_2d(state, pgrid, mesh, capacity=cap)
    return dist, make_distributed2d_step_fn(pgrid, pparams, mesh,
                                            capacity=cap,
                                            density_mode=mode), cap


def _block3d(shape):
    def make(pgrid, pparams, state, mode, cap):
        mesh = make_mesh3d(shape=shape, devices=_devices(shape))
        dist, cap = distribute_state_3d(state, pgrid, mesh, capacity=cap)
        return dist, make_distributed3d_step_fn(pgrid, pparams, mesh,
                                                capacity=cap,
                                                density_mode=mode), cap
    return make


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_degenerate_mesh_matches_the_ports_slabs(continuity):
    """(8, 1, 1) blocks against the port's 8-slab step."""
    _degenerate(_slab8, _block3d((8, 1, 1)), 3, continuity)


def test_degenerate_mesh_matches_the_ports_2d_blocks():
    """(4, 2, 1) blocks against the port's (4, 2) 2-D step."""
    _degenerate(_block2d, _block3d((4, 2, 1)), 5)


# --------------------------------------------------------------------------
# the options and fixed particles
# --------------------------------------------------------------------------


OPTION_CASES = {
    "energy": {"compute_energy": True},
    "xsph": {"xsph": 0.5},
    "density_renorm": {"density_renorm": True},
    "surface_tension": {"surface_tension": 0.5},
}


@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_3d_options_match_reference(option):
    items = tuple(sorted(OPTION_CASES[option].items()))
    hold_run("cloud", (2, 2, 2), seed=7, items=items,
             dudt=option == "energy")


def test_3d_fixed_boundary_particles():
    grid, params, x, v, _rho = _inputs("cloud", 11)
    n_fixed = 24
    v = v.copy()
    v[:n_fixed] = 0.0
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh3d(shape=(2, 2, 2), devices=_devices((2, 2, 2)))
    dist, cap = distribute_state_3d(_port_state(x, v), pgrid, mesh)
    step = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                      n_fixed=n_fixed)
    rmesh = ref_make_mesh3d(shape=(2, 2, 2))
    rdist, _ = ref_distribute(_ref_state(x, v), grid, rmesh)
    rstep = ref_make_step(grid, params, rmesh, capacity=cap, n_fixed=n_fixed)
    for _ in range(3):
        dist, _aux = step(dist)
        rdist, _ = rstep(rdist)
        numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    numpy.testing.assert_allclose(_cat(dist.x), numpy.asarray(rdist.x),
                                  **X_TOL)
    got = collect_state(dist, x.shape[0])
    numpy.testing.assert_array_equal(got.x[:n_fixed], x[:n_fixed])
    numpy.testing.assert_array_equal(got.v[:n_fixed], 0.0)


# --------------------------------------------------------------------------
# the adaptive step and the dump loop
# --------------------------------------------------------------------------


def _adaptive(continuity, seed=11, **kw):
    grid, params, x, v, rho = _inputs("cloud", seed, continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh3d(shape=(2, 2, 2), devices=_devices((2, 2, 2)))
    dist, cap = distribute_state_3d(_port_state(x, v, rho), pgrid, mesh)
    mode = _mode(continuity)
    return dist, pgrid, pparams, mesh, cap, mode, params


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_3d_adaptive_matches_fixed_at_same_dt(continuity):
    dist, pgrid, pparams, mesh, cap, mode, params = _adaptive(continuity)
    fixed = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                       density_mode=mode)
    adaptive = make_adaptive_distributed3d_step_fn(
        pgrid, pparams, mesh, capacity=cap, density_mode=mode)
    assert adaptive.resolved == fixed.resolved
    df, da = dist, dist
    dt = torch.tensor(params.dt, dtype=torch.float32)
    for _ in range(3):
        df, _ = fixed(df)
        da, _, _dt_next = adaptive(da, dt)
    for f, a in zip(df, da):
        if f is not None:
            assert all(torch.equal(tf, ta) for tf, ta in zip(f, a))


def test_3d_adaptive_controller_matches_reference():
    """The controller's inputs, each block's largest |a|^2 and the
    largest |v|^2, within the one-step tolerances of the JAX 3-D step's;
    the port's dt_next is its controller on its own inputs; and its
    controller on the JAX step's inputs within one float32 unit in the
    last place of the reference's rule (tpgsd/sph/step.py:1330-1332)
    evaluated in float64.

    Not dt_next against the JAX dt_next within 1e-7 relative, as the 2-D
    and slab tests hold: here the force condition binds, and the JAX
    adaptive step's own controller arithmetic lands two units below the
    float64 value on its own inputs (2.7e-7 relative; a jitted copy of
    the rule alone lands where the port's does)."""
    from tpgsd_torch.sph.step import _cfl_dt

    dist, pgrid, pparams, mesh, cap, _mode_, params = _adaptive(False, 12)
    dt = torch.tensor(params.dt, dtype=torch.float32)
    adaptive = make_adaptive_distributed3d_step_fn(pgrid, pparams, mesh,
                                                   capacity=cap, cfl=0.3)
    _, _, dt_next = adaptive(dist, dt)
    base = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                      _traced_dt=True)
    out, _aux, a2 = base(dist, dt)
    a2 = torch.stack(a2)
    v2 = torch.amax(torch.stack([torch.amax(torch.sum(v * v, dim=-1))
                                 for v in out.v]))
    assert float(dt_next) == float(_cfl_dt(torch.amax(a2), v2, pparams, 0.3,
                                           0.0, float(params.dt)))

    grid, _params, x, v, _rho = _inputs("cloud", 12)
    rmesh = ref_make_mesh3d(shape=(2, 2, 2))
    rdist, rcap = ref_distribute(_ref_state(x, v), grid, rmesh)
    rbase, _sh = ref_make_step(grid, params, rmesh, capacity=rcap,
                               use_pallas=False, _traced_dt=True)
    rout, _raux, ra2 = jax.jit(rbase)(rdist, jnp.float32(params.dt))
    ra2 = numpy.asarray(ra2)
    rv2 = numpy.max(numpy.sum(numpy.asarray(rout.v) ** 2, axis=-1))
    numpy.testing.assert_allclose(_np(a2), ra2, rtol=1e-5)
    numpy.testing.assert_allclose(float(v2), rv2, rtol=1e-5)
    mine = _cfl_dt(torch.tensor(ra2.max()), torch.tensor(rv2), pparams, 0.3,
                   0.0, float(params.dt))
    a, vv = numpy.float64(ra2.max()), numpy.float64(rv2)
    rule = numpy.clip(0.3 * min(numpy.sqrt(params.h / numpy.sqrt(a)),
                                params.h / (params.c0 + numpy.sqrt(vv))),
                      0.0, params.dt)
    numpy.testing.assert_array_max_ulp(_np(mine), numpy.float32(rule),
                                       maxulp=1)


def test_3d_adaptive_scan_rollout_with_dumps(tmp_path):
    """The port's scan_simulate_adaptive over the 3-D adaptive step with
    frames dumped every 2 steps (tests/test_distributed3d.py:413)."""
    import tpgsd_torch.hoomd
    from tpgsd_torch.io_runtime import JitDumpChannel, scan_simulate_adaptive
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

    dist, pgrid, pparams, mesh, cap, _mode_, params = _adaptive(False, 13)
    step = make_adaptive_distributed3d_step_fn(pgrid, pparams, mesh,
                                               capacity=cap)
    path = tmp_path / "dist3d_scan_ad.gsd"
    channel = JitDumpChannel(ShardedFrameWriter(path, comm=SingleComm()),
                             ["particles/position", "particles/density"])
    final, dt_next, t = scan_simulate_adaptive(
        step, dist, params.dt, n_steps=3, channel=channel,
        frame_of=lambda s, aux: [concat_shards(s.x), concat_shards(aux.rho)],
        every=2)
    channel.close()
    assert 0.0 < float(dt_next) <= float(numpy.float32(params.dt))
    assert 0.0 < float(t) <= 3 * params.dt + 1e-9
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        # frames at steps 0 and 2: the last is the final state
        assert len(traj) == 2
        pos = traj[1].particles.position
        assert pos.shape[0] == 8 * cap and numpy.isfinite(pos).all()
        numpy.testing.assert_array_equal(pos, _cat(final.x))
    assert numpy.isfinite(collect_state(final, 160).x).all()


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer_form,continuity",
                         [("2d", True), ("slab", False)],
                         ids=["2d-continuity", "slab"])
def test_resume_distributed3d_onto_another_shape(tmp_path, writer_form,
                                                 continuity):
    """2 frames written from a (2, 2) 2-D run (or a 2-slab run) resumed
    onto (2, 2, 2): pids in every slot, positions (and carried density)
    as the JAX resume_distributed3d of the same file; a step and an
    appended frame."""
    import tpgsd_torch.hoomd
    from tpgsd.sph.checkpoint import resume_distributed3d as ref_resume
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph import resume_distributed3d

    grid, params, x, v, rho = _inputs("cloud8", 5, vscale=1.0,
                                      continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = _mode(continuity)
    maker = _slab8 if writer_form == "slab" else _block2d
    dist, step, _cap = maker(pgrid, pparams, _port_state(x, v, rho), mode,
                             None)
    n = x.shape[0]
    path = str(tmp_path / "dist3d.gsd")
    writer = ShardedFrameWriter(path, comm=SingleComm())
    for i in range(2):
        dist, _aux = step(dist)
        got = collect_state(dist, n)
        frame = {"particles/position": got.x, "particles/velocity": got.v,
                 "configuration/step": numpy.asarray([i], numpy.uint64)}
        if continuity:
            frame["particles/density"] = got.rho
        writer.write_frame(frame)
    writer.close()

    mesh = make_mesh3d(shape=(2, 2, 2), devices=_devices((2, 2, 2)))
    res, rcap, last, w = resume_distributed3d(path, pgrid, mesh,
                                              density_mode=mode)
    rdist, rrcap, rlast, rw = ref_resume(path, grid,
                                         ref_make_mesh3d(shape=(2, 2, 2)),
                                         density_mode=mode)
    rw.close()
    assert (rcap, last) == (rrcap, rlast) == (rcap, 1)
    numpy.testing.assert_array_equal(_pids(res), numpy.asarray(rdist.pid))
    numpy.testing.assert_array_equal(_cat(res.x), numpy.asarray(rdist.x))
    if continuity:
        numpy.testing.assert_array_equal(_cat(res.rho),
                                         numpy.asarray(rdist.rho))
    step3 = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=rcap,
                                       density_mode=mode)
    res, aux = step3(res)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    got = collect_state(res, n)
    w.write_frame({"particles/position": got.x,
                   "configuration/step": numpy.asarray([2], numpy.uint64)})
    w.close()
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 3
        numpy.testing.assert_array_equal(traj[2].particles.position, got.x)
