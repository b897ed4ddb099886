"""The torch port's slab decomposition (``tpgsd_torch.sph.distributed``)
against the JAX package's (``tpgsd.sph.distributed``, its jnp path on
the suite's 8 virtual CPU devices), one test for each case of
tests/test_distributed.py.

Both packages get the same inputs: the same dam break or Taylor-Green
geometry, velocities drawn from ``numpy.random.default_rng(seed)``, the
state carried over by ``tpgsd_torch.sph.convert``.  The port's mesh is
``make_mesh(devices=["cpu"] * S)`` at the reference's S.  The per-shard
``pid`` arrays must be equal at every step: that proves the staging of
the shards, the migration order and the first-fit insert.  The overflow
counts are equal, and positions, density and velocities agree at the
one-step tolerances.  The reference's Pallas cases (interpret mode) are
mirrored by the port's plain two-tier spill layout against the jnp
path.  The capacity is 32 slots (the spill tiers 16 each): the densest
cell holds 27 particles, and a plain pair pass costs K^2 a cell.
"""

import functools

import jax.numpy as jnp
import numpy
import pytest
import torch

from tpgsd.parallel import make_mesh as ref_make_mesh
from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import taylor_green as ref_taylor_green
from tpgsd.sph.cells import CellGrid as RefGrid
from tpgsd.sph.cells import _sorted_slot_map as ref_sorted_slot_map
from tpgsd.sph.cells import make_grid as ref_make_grid
from tpgsd.sph.distributed import _insert as ref_insert
from tpgsd.sph.distributed import distribute_state as ref_distribute_state
from tpgsd.sph.distributed import (
    make_adaptive_distributed_step_fn as ref_make_adaptive_step_fn,
)
from tpgsd.sph.distributed import (
    make_distributed_step_fn as ref_make_distributed_step_fn,
)
from tpgsd_torch.parallel import make_mesh
from tpgsd_torch.sph import (
    collect_aux,
    collect_state,
    distribute_state,
    make_adaptive_distributed_step_fn,
    make_distributed_step_fn,
    make_step_fn,
    run_adaptive,
)
from tpgsd_torch.sph.cells import _sorted_slot_map
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.distributed import DistState, _insert, concat_shards

CPU = "cpu"
CAP = 32
#: ROADMAP's one-step tolerances of the port against the reference
X_TOL = dict(rtol=1e-5, atol=1e-6)
RHO_RTOL = 1e-5
V_TOL = dict(rtol=1e-4, atol=1e-5)  # on v scaled by its max
#: the reference's tolerances of the decomposed step against the global
#: one (tests/test_distributed.py)
GLOBAL_X = dict(rtol=5e-4, atol=5e-5)
GLOBAL_V = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    same cores, and these steps are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dam(n_side=8):
    """The reference's decomposition dam break (a long box whose 24 x
    cells divide by 2, 4 and 8) at :data:`CAP` slots."""
    db = ref_dam_break(n_side=n_side, box=(4.0, 0.5, 0.5),
                       fill=(0.4, 1.0, 1.0))
    assert db.grid.dims[0] % 8 == 0, db.grid.dims
    return db.grid._replace(capacity=CAP), db.params, numpy.asarray(db.state.x)


def _velocities(x, seed, scale):
    rng = numpy.random.default_rng(seed)
    return (scale * rng.standard_normal(x.shape)).astype(numpy.float32)


@functools.lru_cache(maxsize=None)
def _inputs(kind, seed=0, scale=10.0, continuity=False):
    """``(ref grid, ref params, x, v, rho)`` numpy inputs of one case:
    ``"dam"`` (velocities N(0, scale^2): tens of particles cross a slab
    face in 3 steps) or ``"vortex"`` (the periodic Taylor-Green vortex,
    its own velocities).  ``continuity`` seeds rho with the reference's
    summation density."""
    if kind == "dam":
        grid, params, x = _dam()
        v = _velocities(x, seed, scale)
        periodic = False
    else:
        sc = ref_taylor_green(n_side=21)
        grid, params = sc.grid._replace(capacity=CAP), sc.params
        x, v = numpy.asarray(sc.state.x), numpy.asarray(sc.state.v)
        periodic = True
    rho = None
    if continuity:
        st = ref_init_density(RefState(x=jnp.asarray(x), v=jnp.asarray(v)),
                              grid, params, periodic=periodic)
        rho = numpy.asarray(st.rho)
    return grid, params, x, v, rho


def _port_state(x, v, rho=None):
    return state_from_numpy(x, v, CPU, rho=rho)


def _ref_state(x, v, rho=None):
    return RefState(x=jnp.asarray(x), v=jnp.asarray(v),
                    rho=None if rho is None else jnp.asarray(rho))


def _shards(a, n_sh):
    """A reference ``[S * cap, ...]`` array as a list of shards."""
    a = numpy.asarray(a)
    return numpy.split(a, n_sh)


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------
# the reference trajectories (cached, so several tests share one)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_run(kind, n_sh, n_steps, continuity=False, decomp_axis=0,
             items=()):
    """The JAX decomposed step from :func:`_inputs` ``kind``: a per-step
    list of numpy snapshots ``(x, v, pid, rho, p, cell_ovf, mig_ovf,
    dudt)``, each a list of shards, and the capacity."""
    kw = dict(items)
    grid, params, x, v, rho = _inputs(kind, continuity=continuity)
    mesh = ref_make_mesh(n_devices=n_sh)
    dist, cap = ref_distribute_state(_ref_state(x, v, rho), grid, mesh,
                                     decomp_axis=decomp_axis)
    step = ref_make_distributed_step_fn(
        grid, params, mesh, capacity=cap, use_pallas=False,
        decomp_axis=decomp_axis, periodic=kind == "vortex",
        density_mode="continuity" if continuity else "summation", **kw,
    )
    snaps = []
    for _ in range(n_steps):
        dist, aux = step(dist)
        snaps.append(tuple(
            _shards(a, n_sh) for a in (dist.x, dist.v, dist.pid, aux.rho,
                                       aux.p, aux.cell_overflow,
                                       aux.migrate_overflow, aux.dudt)
        ))
    return snaps, cap


def _port_run(kind, n_sh, n_steps, continuity=False, decomp_axis=0,
              items=(), spill=False):
    """The port's decomposed step on the same inputs, plain pair passes
    (``spill``: the plain two-tier layout, half the capacity a tier)."""
    grid, params, x, v, rho = _inputs(kind, continuity=continuity)
    pgrid = grid_from_reference(grid)
    if spill:
        pgrid = pgrid._replace(capacity=CAP // 2)
    mesh = make_mesh(devices=[CPU] * n_sh)
    dist, cap = distribute_state(_port_state(x, v, rho), pgrid, mesh,
                                 decomp_axis=decomp_axis)
    step = make_distributed_step_fn(
        pgrid, params_from_reference(params), mesh, capacity=cap,
        use_kernels=False, spill=spill, decomp_axis=decomp_axis,
        periodic=kind == "vortex",
        density_mode="continuity" if continuity else "summation",
        **dict(items),
    )
    assert step.resolved == {
        "use_kernels": False, "spill": spill,
        "density_mode": "continuity" if continuity else "summation",
    }
    out = []
    for _ in range(n_steps):
        dist, aux = step(dist)
        out.append((dist, aux))
    return out, cap, x.shape[0]


def _hold_step(ref_snap, dist, aux, i, dudt=False):
    """Step ``i`` of the port against the reference's snapshot."""
    rx, rv, rpid, rrho, _rp, rcov, rmov, rdu = ref_snap
    n_sh = len(rx)
    for d in range(n_sh):
        numpy.testing.assert_array_equal(
            _np(dist.pid[d]), rpid[d], err_msg="step %d shard %d pid" % (i, d))
    assert [int(c) for c in aux.cell_overflow] == [int(c[0]) for c in rcov]
    assert [int(c) for c in aux.migrate_overflow] == [int(c[0]) for c in rmov]
    live = numpy.concatenate(rpid) >= 0
    cat = numpy.concatenate
    numpy.testing.assert_allclose(cat([_np(t) for t in dist.x]), cat(rx),
                                  **X_TOL, err_msg="step %d x" % i)
    numpy.testing.assert_allclose(cat([_np(t) for t in aux.rho])[live],
                                  cat(rrho)[live], rtol=RHO_RTOL,
                                  err_msg="step %d rho" % i)
    vr = cat(rv)
    scale = numpy.abs(vr).max()
    numpy.testing.assert_allclose(cat([_np(t) for t in dist.v]) / scale,
                                  vr / scale, **V_TOL,
                                  err_msg="step %d v" % i)
    if dudt:
        dr = cat(rdu)[live]
        du_scale = numpy.abs(dr).max()
        assert du_scale > 0
        numpy.testing.assert_allclose(
            cat([_np(t) for t in aux.dudt])[live] / du_scale,
            dr / du_scale, rtol=1e-4, atol=1e-5,
        )


def _hold_run(kind, n_sh, n_steps=3, continuity=False, decomp_axis=0,
              items=(), spill=False, dudt=False):
    snaps, cap = _ref_run(kind, n_sh, n_steps, continuity, decomp_axis,
                          items)
    out, cap_p, n = _port_run(kind, n_sh, n_steps, continuity, decomp_axis,
                              items, spill)
    assert cap_p == cap
    for i, (snap, (dist, aux)) in enumerate(zip(snaps, out)):
        _hold_step(snap, dist, aux, i, dudt)
    return out, n


def _migrations(out):
    """Particles that changed shard over the run."""
    first = out[0][0].pid
    last = out[-1][0].pid
    return sum(
        int(((b >= 0) & ~torch.isin(b, a)).sum()) for a, b in zip(first, last)
    )


# --------------------------------------------------------------------------
# the mesh and the helpers
# --------------------------------------------------------------------------


def test_make_mesh_on_explicit_devices():
    mesh = make_mesh(devices=[CPU] * 4)
    assert mesh.size == 4
    assert mesh.devices == (torch.device(CPU),) * 4
    assert make_mesh(2, devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="got 3 devices"):
        make_mesh(2, devices=[CPU] * 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_make_mesh_without_a_gpu_raises():
    """No silent CPU mesh: the default mesh is the visible GPUs."""
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(n_devices=2)


def test_make_mesh_counts_the_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(n_devices=1).size == 1
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        make_mesh(n_devices=4)


@pytest.mark.parametrize("capacity,live_rows", [(4, None), (4, 5), (3, 2)])
def test_sorted_slot_map_live_rows_matches_reference(capacity, live_rows):
    rng = numpy.random.default_rng(1)
    cid = rng.integers(0, 6, size=40).astype(numpy.int32)
    got = _sorted_slot_map(torch.from_numpy(cid.astype(numpy.int64)), 6,
                           capacity, live_rows=live_rows)
    want = ref_sorted_slot_map(jnp.asarray(cid), 6, capacity,
                               live_rows=live_rows)
    for g, w in zip(got, want):
        numpy.testing.assert_array_equal(_np(g), numpy.asarray(w))
    if live_rows is not None:
        assert not _np(got[2])[live_rows:].any()
    # the callers that pass no live_rows get what they got before
    if live_rows is None:
        base = _sorted_slot_map(torch.from_numpy(cid.astype(numpy.int64)),
                                6, capacity, live_rows=6)
        for g, b in zip(got, base):
            assert torch.equal(g, b)


def test_insert_compacts_receive_buffer():
    """A migrant landing in the from-right block of the stacked receive
    buffer still takes the first free slot; with no free slot the loss
    is counted, as the reference's ``_insert``."""
    n, mig_cap = 8, 2
    values = torch.zeros((n, 1))
    alive = torch.tensor([True] * 6 + [False] * 2)
    recv_vals = torch.zeros((2 * mig_cap, 1))
    recv_vals[mig_cap, 0] = 42.0
    recv_valid = torch.zeros(2 * mig_cap, dtype=torch.bool)
    recv_valid[mig_cap] = True

    (merged,), lost = _insert([values], alive, [recv_vals], recv_valid)
    ref_merged, ref_lost = ref_insert(
        jnp.asarray(_np(values)), jnp.asarray(_np(alive)),
        jnp.asarray(_np(recv_vals)), jnp.asarray(_np(recv_valid)),
    )
    assert int(lost) == int(ref_lost) == 0
    assert float(merged[6, 0]) == 42.0
    numpy.testing.assert_array_equal(_np(merged), numpy.asarray(ref_merged))

    (merged2,), lost2 = _insert([values], torch.ones(n, dtype=torch.bool),
                                [recv_vals], recv_valid)
    assert int(lost2) == 1
    assert torch.equal(merged2, torch.zeros((n, 1)))


def test_grid_divisibility_guard():
    grid, params, _ = _dam()
    pgrid = grid_from_reference(grid)._replace(dims=(25, 3, 3))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        make_distributed_step_fn(pgrid, params_from_reference(params),
                                 make_mesh(devices=[CPU] * 2), capacity=64)
    with pytest.raises(ValueError, match="capacity"):
        make_distributed_step_fn(grid_from_reference(grid),
                                 params_from_reference(params),
                                 make_mesh(devices=[CPU] * 2))


# --------------------------------------------------------------------------
# the step against the reference's, step by step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_distributed_step_matches_reference(continuity, spill):
    """3 steps on 4 shards with tens of slab crossings: per-shard pids
    equal, overflows equal, x, rho and v within the one-step
    tolerances."""
    out, _n = _hold_run("dam", 4, continuity=continuity, spill=spill)
    assert _migrations(out) > 0


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_distributed_step_matches_own_global_step(continuity):
    """The decomposed step against the port's global step on the same
    state (as the reference holds its own), 3 steps on 2 shards."""
    grid, params, x, v, rho = _inputs("dam", continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = "continuity" if continuity else "summation"
    step_g = make_step_fn(pgrid, pparams, density_mode=mode, device=CPU)
    sg = _port_state(x, v, rho)
    for _ in range(3):
        sg, _ = step_g(sg)
    out, _cap, n = _port_run("dam", 2, 3, continuity=continuity)
    dist, aux = out[-1]
    pid = numpy.concatenate([_np(p) for p in dist.pid])
    assert sorted(pid[pid >= 0].tolist()) == list(range(n))
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    got = collect_state(dist, n)
    numpy.testing.assert_allclose(got.x, _np(sg.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.v, _np(sg.v), **GLOBAL_V)
    if continuity:
        numpy.testing.assert_allclose(got.rho, _np(sg.rho), rtol=1e-4)
        # aux density and pressure describe the post-migration slots
        live = pid >= 0
        numpy.testing.assert_array_equal(
            numpy.concatenate([_np(r) for r in aux.rho])[live],
            numpy.concatenate([_np(r) for r in dist.rho])[live])


def _two_particles(x, v, rho=None, n_sh=8, capacity=8, h=0.25, **kw):
    """The reference's isolated-particle meshes: an 8 x 1 x 1 box of
    0.5 cells, both packages stepped once a call."""
    grid = ref_make_grid((0, 0, 0), (8.0, 1.0, 1.0), 0.5, capacity=16)
    params = RefParams(mass=1.0, h=h, dt=0.1, gravity=(0.0, 0.0, 0.0))
    x = numpy.asarray(x, numpy.float32)
    v = numpy.asarray(v, numpy.float32)
    mesh = make_mesh(devices=[CPU] * n_sh)
    dist, _ = distribute_state(_port_state(x, v, rho), grid_from_reference(
        grid), mesh, capacity=capacity)
    step = make_distributed_step_fn(grid_from_reference(grid),
                                    params_from_reference(params), mesh,
                                    capacity=capacity, **kw)
    rmesh = ref_make_mesh(n_devices=n_sh)
    rdist, _ = ref_distribute_state(_ref_state(x, v, rho), grid, rmesh,
                                    capacity=capacity)
    rstep = ref_make_distributed_step_fn(grid, params, rmesh,
                                         capacity=capacity, **kw)
    return dist, step, rdist, rstep


def _pids(dist):
    return numpy.concatenate([_np(p) for p in dist.pid])


def test_migration_across_slabs():
    dist, step, rdist, rstep = _two_particles(
        [[0.95, 0.5, 0.5], [4.05, 0.5, 0.5]],
        [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
    )
    for _ in range(2):
        dist, aux = step(dist)
        rdist, _ = rstep(rdist)
        numpy.testing.assert_array_equal(_pids(dist),
                                         numpy.asarray(rdist.pid))
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    got = collect_state(dist, 2)
    numpy.testing.assert_allclose(got.x[0, 0], 0.95 + 0.2, rtol=1e-5)
    numpy.testing.assert_allclose(got.x[1, 0], 4.05 + 0.2, rtol=1e-5)
    # both crossed a face: they live on shards 1 and 4 now
    assert 0 in _np(dist.pid[1]) and 1 in _np(dist.pid[4])


def test_left_migration_into_busy_slab():
    residents = numpy.stack([
        numpy.full(6, 0.5, numpy.float32),
        numpy.linspace(0.1, 0.9, 6, dtype=numpy.float32),
        numpy.asarray([0.2, 0.8] * 3, numpy.float32),
    ], axis=1)
    x = numpy.concatenate([residents, [[1.02, 0.5, 0.5]]])
    v = numpy.zeros_like(x)
    v[6, 0] = -1.0
    dist, step, rdist, rstep = _two_particles(x, v, h=0.05)
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    pid = _pids(dist)
    numpy.testing.assert_array_equal(pid, numpy.asarray(rdist.pid))
    assert set(pid[pid >= 0].tolist()) == set(range(7))
    assert 6 in _np(dist.pid[0]).tolist()


def test_periodic_ring_migration():
    dist, step, rdist, rstep = _two_particles(
        [[0.05, 0.2, 0.2], [7.95, 0.8, 0.8]],
        [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], periodic=True,
    )
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    got = collect_state(dist, 2)
    numpy.testing.assert_allclose(got.x[0, 0], 8.0 - 0.05, rtol=1e-5)
    numpy.testing.assert_allclose(got.x[1, 0], 0.05, rtol=1e-4, atol=1e-5)
    numpy.testing.assert_allclose(got.x, collect_state_ref(rdist, 2),
                                  rtol=1e-6)
    assert 0 in _np(dist.pid[7]) and 1 in _np(dist.pid[0])


def collect_state_ref(rdist, n):
    pid = numpy.asarray(rdist.pid)
    out = numpy.zeros((n, 3), numpy.float32)
    out[pid[pid >= 0]] = numpy.asarray(rdist.x)[pid >= 0]
    return out


def test_continuity_migration_carries_density():
    dist, step, rdist, rstep = _two_particles(
        [[0.95, 0.5, 0.5], [4.05, 0.5, 0.5]],
        [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
        rho=numpy.asarray([1234.5, 987.25], numpy.float32),
        density_mode="continuity", delta_sph=0.0,
    )
    for _ in range(2):
        dist, aux = step(dist)
        rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    got = collect_state(dist, 2)
    numpy.testing.assert_allclose(got.x[0, 0], 0.95 + 0.2, rtol=1e-5)
    numpy.testing.assert_array_equal(
        got.rho, numpy.asarray([1234.5, 987.25], numpy.float32))


def test_send_overflow_keeps_the_particle_one_more_step():
    """Two particles cross one face with room for one migrant a face:
    the second waits a step on its own slab (raw x kept), counted in
    migrate_overflow, as the reference does."""
    x = [[0.95, 0.3, 0.3], [0.96, 0.7, 0.7]]
    v = [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    dist, step, rdist, rstep = _two_particles(x, v, migrate_cap=1)
    ovf = []
    for _ in range(2):
        dist, aux = step(dist)
        rdist, raux = rstep(rdist)
        numpy.testing.assert_array_equal(_pids(dist),
                                         numpy.asarray(rdist.pid))
        numpy.testing.assert_allclose(
            numpy.concatenate([_np(t) for t in dist.x]),
            numpy.asarray(rdist.x), rtol=1e-6)
        ovf.append([int(c) for c in aux.migrate_overflow])
        assert ovf[-1] == numpy.asarray(raux.migrate_overflow).tolist()
    assert sum(ovf[0]) == 1 and sum(ovf[1]) == 0
    assert set(_np(dist.pid[1]).tolist()) >= {0, 1}


def test_distributed_boundary_particles():
    """A floor of fixed particles (pid < n_fixed): sources on every slab
    that never move or migrate; matches the reference and the port's
    global n_fixed step."""
    dx = 0.1
    h = 1.3 * dx
    support = 2.0 * h
    n_sh = 4
    nx_cells = n_sh * 2
    lx, ly = nx_cells * support, 0.2
    gx, gy = numpy.meshgrid(numpy.arange(dx / 2, lx, dx),
                            numpy.arange(dx / 2, ly, dx), indexing="ij")
    wall = numpy.stack([gx.ravel(), gy.ravel(), numpy.full(gx.size, dx / 2)],
                       axis=1).astype(numpy.float32)
    fx, fy, fz = numpy.meshgrid(
        numpy.arange(lx * 0.3, lx * 0.7, dx), numpy.arange(dx / 2, ly, dx),
        numpy.arange(1.5 * dx, 1.5 * dx + 4 * dx, dx), indexing="ij",
    )
    fluid = numpy.stack([fx.ravel(), fy.ravel(), fz.ravel()],
                        axis=1).astype(numpy.float32)
    x0 = numpy.concatenate([wall, fluid])
    n_fixed, n = wall.shape[0], x0.shape[0]
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=support,
                   dims=(nx_cells, 1, max(1, int(0.5 / support))),
                   capacity=CAP)
    params = RefParams(mass=1000.0 * dx**3, h=h, dt=2e-4, c0=30.0, alpha=0.3)
    v0 = numpy.zeros_like(x0)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)

    mesh = make_mesh(devices=[CPU] * n_sh)
    dist, cap = distribute_state(_port_state(x0, v0), pgrid, mesh)
    step = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap,
                                    n_fixed=n_fixed)
    rmesh = ref_make_mesh(n_devices=n_sh)
    rdist, rcap = ref_distribute_state(_ref_state(x0, v0), grid, rmesh)
    rstep = ref_make_distributed_step_fn(grid, params, rmesh, capacity=rcap,
                                         n_fixed=n_fixed)
    step_g = make_step_fn(pgrid, pparams, n_fixed=n_fixed, device=CPU)
    sg = _port_state(x0, v0)
    assert cap == rcap
    for _ in range(3):
        dist, aux = step(dist)
        rdist, _ = rstep(rdist)
        sg, _ = step_g(sg)
        numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    assert sum(int(c) for c in aux.cell_overflow) == 0
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    got = collect_state(dist, n)
    numpy.testing.assert_array_equal(got.x[:n_fixed], x0[:n_fixed])
    numpy.testing.assert_array_equal(got.v[:n_fixed], 0.0)
    numpy.testing.assert_allclose(got.x, collect_state_ref(rdist, n), **X_TOL)
    numpy.testing.assert_allclose(got.x, _np(sg.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.v, _np(sg.v), **GLOBAL_V)


# --------------------------------------------------------------------------
# periodic boxes and the y decomposition
# --------------------------------------------------------------------------


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_periodic_matches_reference_and_single_device(continuity, spill):
    """The periodic Taylor-Green vortex on a ring of 4 shards (x through
    the ring, y wrapped locally): the reference step by step, and the
    port's global periodic step."""
    out, n = _hold_run("vortex", 4, continuity=continuity, spill=spill)
    grid, params, x, v, rho = _inputs("vortex", continuity=continuity)
    step_g = make_step_fn(grid_from_reference(grid),
                          params_from_reference(params), periodic=True,
                          density_mode="continuity" if continuity
                          else "summation", device=CPU)
    sg = _port_state(x, v, rho)
    for _ in range(3):
        sg, _ = step_g(sg)
    got = collect_state(out[-1][0], n)
    numpy.testing.assert_allclose(got.x, _np(sg.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.v, _np(sg.v), **GLOBAL_V)
    if continuity:
        numpy.testing.assert_allclose(got.rho, _np(sg.rho), rtol=1e-4)


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_y_decomposition_matches_reference_and_x(continuity):
    """decomp_axis=1 on the vortex (ny = 8 divides by 4): the reference's
    y decomposition step by step, and the port's x decomposition."""
    out_y, n = _hold_run("vortex", 4, continuity=continuity, decomp_axis=1)
    out_x, _cap, _n = _port_run("vortex", 4, 3, continuity=continuity)
    gx = collect_state(out_x[-1][0], n)
    gy = collect_state(out_y[-1][0], n)
    numpy.testing.assert_allclose(gy.x, gx.x, rtol=1e-5, atol=1e-6)
    if continuity:
        numpy.testing.assert_allclose(gy.rho, gx.rho, rtol=1e-5)


def test_periodic_yz_wrap_commits_to_state():
    """A particle crossing a periodic y boundary is stored wrapped (only
    the x seam keeps raw coordinates, and only for held-back
    migrants)."""
    n_sh = 8
    grid = grid_from_reference(RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25,
                                       dims=(n_sh, 4, 4), capacity=8))
    params = params_from_reference(RefParams(
        mass=0.01, h=0.12, dt=0.05, gravity=(0.0, 0.0, 0.0), alpha=0.0))
    x = torch.full((n_sh, 8, 3), -1.0)
    v = torch.zeros((n_sh, 8, 3))
    pid = torch.full((n_sh, 8), -1, dtype=torch.int32)
    for d in range(n_sh):
        x[d, 0] = torch.tensor([(d + 0.5) * 0.25, 0.95, 0.5])
        v[d, 0] = torch.tensor([0.0, 1.0, 0.0])
        pid[d, 0] = d
    dist = DistState(x=tuple(x), v=tuple(v), pid=tuple(pid))
    step = make_distributed_step_fn(grid, params,
                                    make_mesh(devices=[CPU] * n_sh),
                                    capacity=8, periodic=True)
    for _ in range(12):
        dist, _aux = step(dist)
    ys = numpy.concatenate([_np(t) for t in dist.x])[_pids(dist) >= 0, 1]
    assert (ys >= 0.0).all() and (ys <= 1.0).all(), ys
    assert sorted(_pids(dist)[_pids(dist) >= 0].tolist()) == list(range(n_sh))


# --------------------------------------------------------------------------
# the options
# --------------------------------------------------------------------------


OPTION_CASES = {
    "energy": {"compute_energy": True},
    "xsph": {"xsph": 0.5},
    "density_renorm": {"density_renorm": True},
    "surface_tension": {"surface_tension": 0.5},
}


@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_options_match_reference_and_single_device(option, spill):
    """Each option on 4 shards: the reference step by step (du/dt too),
    and, but for the energy rate, which the global step does not
    integrate, the port's global step with the same option."""
    kw = OPTION_CASES[option]
    items = tuple(sorted(kw.items()))
    out, n = _hold_run("dam", 4, items=items, spill=spill,
                       dudt=option == "energy")
    dist, aux = out[-1]
    if option == "energy":
        return
    if option == "density_renorm":
        live = _pids(dist) >= 0
        rho = numpy.concatenate([_np(r) for r in aux.rho])
        assert (rho[live] >= 1000.0 - 1e-3).all()
    grid, params, x, v, _rho = _inputs("dam")
    step_g = make_step_fn(grid_from_reference(grid),
                          params_from_reference(params), device=CPU, **kw)
    sg = _port_state(x, v)
    for _ in range(3):
        sg, _ = step_g(sg)
    got = collect_state(dist, n)
    numpy.testing.assert_allclose(got.x, _np(sg.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.v, _np(sg.v), **GLOBAL_V)


def test_energy_off_leaves_dudt_zero():
    out, _cap, _n = _port_run("dam", 2, 1)
    assert all(float(t.abs().max()) == 0.0 for t in out[0][1].dudt)


def test_continuity_composes_xsph_surface_tension_energy():
    items = (("compute_energy", True), ("surface_tension", 0.05),
             ("xsph", 0.3))
    out, n = _hold_run("dam", 4, n_steps=2, continuity=True, items=items,
                       dudt=True)
    grid, params, x, v, rho = _inputs("dam", continuity=True)
    step_g = make_step_fn(grid_from_reference(grid),
                          params_from_reference(params), device=CPU,
                          density_mode="continuity", xsph=0.3,
                          surface_tension=0.05)
    sg = _port_state(x, v, rho)
    for _ in range(2):
        sg, _ = step_g(sg)
    got = collect_state(out[-1][0], n)
    numpy.testing.assert_allclose(got.x, _np(sg.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.rho, _np(sg.rho), rtol=1e-4)


def test_continuity_guards():
    grid, params, x, v, _ = _inputs("dam")
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh(devices=[CPU] * 2)
    with pytest.raises(ValueError, match="density_renorm"):
        make_distributed_step_fn(pgrid, pparams, mesh, capacity=64,
                                 density_mode="continuity",
                                 density_renorm=True)
    with pytest.raises(ValueError, match="density_mode"):
        make_distributed_step_fn(pgrid, pparams, mesh, capacity=64,
                                 density_mode="bogus")
    with pytest.raises(ValueError, match="decomp_axis"):
        make_distributed_step_fn(pgrid, pparams, mesh, capacity=64,
                                 decomp_axis=2)
    with pytest.raises(ValueError, match="use_kernels=True needs a CUDA"):
        make_distributed_step_fn(pgrid, pparams, mesh, capacity=64,
                                 use_kernels=True)
    dist, cap = distribute_state(_port_state(x, v), pgrid, mesh)
    step = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap,
                                    density_mode="continuity")
    with pytest.raises(ValueError, match="init_density"):
        step(dist)
    step = make_distributed_step_fn(pgrid, pparams,
                                    make_mesh(devices=[CPU] * 4),
                                    capacity=cap)
    with pytest.raises(ValueError, match="4 shards"):
        step(dist)


# --------------------------------------------------------------------------
# the adaptive step
# --------------------------------------------------------------------------


def _adaptive_pair(continuity, n_sh=2, decomp_axis=0, **kw):
    grid, params, x, v, rho = _inputs("dam", continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh(devices=[CPU] * n_sh)
    dist, cap = distribute_state(_port_state(x, v, rho), pgrid, mesh,
                                 decomp_axis=decomp_axis)
    mode = "continuity" if continuity else "summation"
    fixed = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap,
                                     density_mode=mode,
                                     decomp_axis=decomp_axis)
    adaptive = make_adaptive_distributed_step_fn(
        pgrid, pparams, mesh, capacity=cap, density_mode=mode,
        decomp_axis=decomp_axis, **kw)
    return dist, fixed, adaptive, params


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_adaptive_matches_fixed_at_same_dt(continuity):
    dist, fixed, adaptive, params = _adaptive_pair(continuity)
    assert adaptive.resolved == fixed.resolved
    df, da = dist, dist
    dt = torch.tensor(params.dt, dtype=torch.float32)
    for _ in range(3):
        df, _ = fixed(df)
        da, _, _dt_next = adaptive(da, dt)
    for f, a in zip(df, da):
        if f is None:
            continue
        for tf, ta in zip(f, a):
            assert torch.equal(tf, ta)


def test_adaptive_controller_matches_reference():
    """dt_next of one adaptive step equals the reference's within 1e-7
    relative (both max over the same physics, reduced across shards)."""
    grid, params, x, v, _ = _inputs("dam")
    dist, fixed, adaptive, _ = _adaptive_pair(False, n_sh=4, cfl=0.3)
    _, _, dt_next = adaptive(dist, torch.tensor(params.dt,
                                                dtype=torch.float32))
    rmesh = ref_make_mesh(n_devices=4)
    rdist, cap = ref_distribute_state(_ref_state(x, v), grid, rmesh)
    rstep = ref_make_adaptive_step_fn(grid, params, rmesh, capacity=cap,
                                      cfl=0.3, use_pallas=False)
    _, _, rdt = rstep(rdist, jnp.float32(params.dt))
    numpy.testing.assert_allclose(float(dt_next), float(rdt), rtol=1e-7)


def test_adaptive_rollout_with_migration():
    dist, _fixed, adaptive, params = _adaptive_pair(False, n_sh=4, cfl=0.3)
    n = sum(int((p >= 0).sum()) for p in dist.pid)
    out, dt, t = run_adaptive(adaptive, dist, params.dt, 12)
    assert 0.0 < float(dt) <= float(numpy.float32(params.dt))
    assert float(t) > 0.0
    pid = _pids(out)
    assert sorted(pid[pid >= 0].tolist()) == list(range(n))
    assert numpy.isfinite(collect_state(out, n).x).all()
    moved = sum(int(((b >= 0) & ~torch.isin(b, a)).sum())
                for a, b in zip(dist.pid, out.pid))
    assert moved > 0


def test_adaptive_y_decomposition():
    db = ref_dam_break(n_side=8, box=(0.5, 4.0, 0.5), fill=(1.0, 0.4, 1.0))
    assert db.grid.dims[1] % 4 == 0, db.grid.dims
    grid = db.grid._replace(capacity=CAP)
    x = numpy.asarray(db.state.x)
    v = _velocities(x, 2, 1.0)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(
        db.params)
    mesh = make_mesh(devices=[CPU] * 4)
    dist, cap = distribute_state(_port_state(x, v), pgrid, mesh,
                                 decomp_axis=1)
    step = make_adaptive_distributed_step_fn(pgrid, pparams, mesh,
                                             capacity=cap, decomp_axis=1,
                                             cfl=0.3)
    rmesh = ref_make_mesh(n_devices=4)
    rdist, rcap = ref_distribute_state(_ref_state(x, v), grid, rmesh,
                                       decomp_axis=1)
    rstep = ref_make_adaptive_step_fn(grid, db.params, rmesh, capacity=rcap,
                                      decomp_axis=1, cfl=0.3,
                                      use_pallas=False)
    dt = torch.tensor(db.params.dt, dtype=torch.float32)
    rdt = jnp.float32(db.params.dt)
    for _ in range(3):
        dist, aux, dt = step(dist, dt)
        rdist, _, rdt = rstep(rdist, rdt)
        numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    assert 0.0 < float(dt) <= float(numpy.float32(db.params.dt))
    numpy.testing.assert_allclose(float(dt), float(rdt), rtol=1e-6)
    assert sum(int(c) for c in aux.cell_overflow) == 0
    numpy.testing.assert_allclose(
        numpy.concatenate([_np(t) for t in dist.x]), numpy.asarray(rdist.x),
        **X_TOL)


# --------------------------------------------------------------------------
# composition: the dump loop, collect, resume
# --------------------------------------------------------------------------


def test_scan_simulate_distributed(tmp_path):
    import tpgsd_torch.hoomd
    from tpgsd_torch.io_runtime import JitDumpChannel, scan_simulate
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

    grid, params, x, v, _ = _inputs("dam")
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh(devices=[CPU] * 2)
    dist, cap = distribute_state(_port_state(x, v), pgrid, mesh)
    step = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap)
    path = tmp_path / "dist_scan.gsd"
    channel = JitDumpChannel(
        ShardedFrameWriter(path, comm=SingleComm()),
        ["particles/position", "particles/density"],
    )
    final = scan_simulate(
        step, dist, n_steps=3, channel=channel,
        frame_of=lambda s, aux: [concat_shards(s.x), concat_shards(aux.rho)],
        every=2,
    )
    channel.close()
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 2
        pos = traj[1].particles.position
        assert pos.shape[0] == 2 * cap
        # frames at steps 0 and 2: the last is the final state
        numpy.testing.assert_array_equal(
            pos, numpy.concatenate([_np(t) for t in final.x]))
    assert numpy.isfinite(collect_state(final, x.shape[0]).x).all()


def test_collect_aux_orders_by_pid():
    out, _cap, n = _port_run("dam", 4, 1, items=(("compute_energy", True),))
    dist, aux = out[0]
    rho, p, du = collect_aux(dist, aux, n, params=_dam()[1])
    pid = _pids(dist)
    live = pid >= 0
    numpy.testing.assert_array_equal(
        rho[pid[live]], numpy.concatenate([_np(r) for r in aux.rho])[live])
    assert numpy.isfinite(p).all() and numpy.abs(du).max() > 0
    rho_none, _, _ = collect_aux(dist, aux, n + 3)
    assert (rho_none[n:] == 0.0).all()


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_resume_distributed_onto_another_shard_count(tmp_path, continuity):
    """Write 2 frames from a 2-shard run, resume onto 4 shards: the same
    positions (and carried density) and pid sets as the reference's
    resume_distributed of the same file, and the writer appends."""
    import tpgsd_torch.hoomd
    from tpgsd.sph.checkpoint import resume_distributed as ref_resume
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph import resume_distributed

    grid, params, x, v, rho = _inputs("dam", continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = "continuity" if continuity else "summation"
    mesh2 = make_mesh(devices=[CPU] * 2)
    dist, cap = distribute_state(_port_state(x, v, rho), pgrid, mesh2)
    step = make_distributed_step_fn(pgrid, pparams, mesh2, capacity=cap,
                                    density_mode=mode)
    n = x.shape[0]
    path = str(tmp_path / "dist.gsd")
    writer = ShardedFrameWriter(path, comm=SingleComm())
    for i in range(2):
        dist, aux = step(dist)
        got = collect_state(dist, n)
        frame = {"particles/position": got.x, "particles/velocity": got.v,
                 "configuration/step": numpy.asarray([i], numpy.uint64)}
        if continuity:
            frame["particles/density"] = got.rho
        writer.write_frame(frame)
    writer.close()

    mesh4 = make_mesh(devices=[CPU] * 4)
    dist4, cap4, last, w = resume_distributed(path, pgrid, mesh4,
                                              density_mode=mode)
    rdist, rcap, rlast, rw = ref_resume(path, grid, ref_make_mesh(
        n_devices=4), density_mode=mode)
    rw.close()
    assert (cap4, last) == (rcap, rlast) == (cap4, 1)
    numpy.testing.assert_array_equal(_pids(dist4), numpy.asarray(rdist.pid))
    numpy.testing.assert_array_equal(
        numpy.concatenate([_np(t) for t in dist4.x]), numpy.asarray(rdist.x))
    if continuity:
        numpy.testing.assert_array_equal(
            numpy.concatenate([_np(t) for t in dist4.rho]),
            numpy.asarray(rdist.rho))
    assert set(_pids(dist4)[_pids(dist4) >= 0].tolist()) == set(range(n))
    step4 = make_distributed_step_fn(pgrid, pparams, mesh4, capacity=cap4,
                                     density_mode=mode)
    dist4, _ = step4(dist4)
    got = collect_state(dist4, n)
    w.write_frame({"particles/position": got.x,
                   "configuration/step": numpy.asarray([2], numpy.uint64)})
    w.close()
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 3
        numpy.testing.assert_array_equal(traj[2].particles.position, got.x)
