"""The torch port's 2-D block decomposition
(``tpgsd_torch.sph.distributed2d``) against the JAX package's
(``tpgsd.sph.distributed2d``, its jnp path on the suite's 8 virtual CPU
devices), one test for each case of tests/test_distributed2d.py, and the
two places where the port departs from the reference on purpose.

Both packages get the same inputs: the reference's random cloud (160
particles on an (8, 4, 4) grid, ``numpy.random.RandomState(seed)``) and
its periodic Taylor-Green vortex, the state carried over by
``tpgsd_torch.sph.convert``.  The port's mesh is ``make_mesh2d(shape,
devices=["cpu"] * n)`` at the reference's shape.  The per-shard ``pid``
arrays must be equal at every step (the staging of the halo axes and
of the migration hops, and the first-fit insert), the overflow counts
equal, and positions, density and velocities within the one-step
tolerances.  The reference's Pallas cases are mirrored by the port's
plain two-tier spill layout against the jnp path.
"""

import functools

import jax.numpy as jnp
import numpy
import pytest
import torch

from tpgsd.parallel import make_mesh2d as ref_make_mesh2d
from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph import taylor_green as ref_taylor_green
from tpgsd.sph.cells import CellGrid as RefGrid
from tpgsd.sph.distributed2d import distribute_state_2d as ref_distribute
from tpgsd.sph.distributed2d import (
    make_adaptive_distributed2d_step_fn as ref_make_adaptive,
)
from tpgsd.sph.distributed2d import make_distributed2d_step_fn as ref_make_step
from tpgsd_torch.parallel import Mesh, make_mesh, make_mesh2d, make_mesh3d
from tpgsd_torch.parallel.exchange import Exchange
from tpgsd_torch.sph import (
    collect_state,
    distribute_state,
    distribute_state_2d,
    distribute_state_3d,
    make_adaptive_distributed2d_step_fn,
    make_distributed2d_step_fn,
    make_distributed3d_step_fn,
    make_distributed_step_fn,
    run_adaptive,
)
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.distributed import _block_neighbours, _migrate_axis

CPU = "cpu"
#: ROADMAP's one-step tolerances of the port against the reference
X_TOL = dict(rtol=1e-5, atol=1e-6)
RHO_RTOL = 1e-5
V_TOL = dict(rtol=1e-4, atol=1e-5)  # on v scaled by its max
#: the reference's tolerances of a decomposed step against the global
#: one (tests/test_distributed.py:98-104)
GLOBAL_X = dict(rtol=5e-4, atol=5e-5)
GLOBAL_V = dict(rtol=5e-3, atol=5e-3)
#: and of a degenerate mesh against the lower-dimensional form
#: (tests/test_distributed2d.py:193-215)
DEGENERATE_X = dict(rtol=1e-5, atol=1e-6)
DEGENERATE_V = dict(rtol=1e-4, atol=1e-5)


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


def _cloud_params():
    return RefParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                     gravity=(0.0, 0.0, -9.81))


@functools.lru_cache(maxsize=None)
def _inputs(kind, seed=0, vscale=0.05, continuity=False):
    """``(ref grid, ref params, x, v, rho)`` numpy inputs: ``"cloud"``,
    the reference's random cloud (tests/test_distributed2d.py:30-42;
    ``vscale`` its velocity scale, 0.05 m/s there, 10 m/s to cross
    faces), or ``"vortex"``, the periodic Taylor-Green vortex.
    ``continuity`` seeds rho with the reference's summation density."""
    if kind == "cloud":
        grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                       capacity=16)
        rng = numpy.random.RandomState(seed)
        x = rng.uniform(0.05, 0.95, (160, 3)).astype(numpy.float32)
        x[:, 0] *= 2.0
        v = (rng.randn(160, 3) * vscale).astype(numpy.float32)
        params, periodic = _cloud_params(), False
    elif kind == "movers":
        # the cloud at ``vscale``, its first 4 particles 4 mm from the
        # corner of the (2, 2) mesh's blocks, one in each block, moving
        # across the corner to the opposite block
        grid, params, x, v, _rho = _inputs("cloud", seed, vscale)
        x, v = x.copy(), v.copy()
        sx = numpy.asarray([-1, 1, -1, 1], numpy.float32)
        sy = numpy.asarray([-1, 1, 1, -1], numpy.float32)
        x[:4] = numpy.stack([1.0 + 0.004 * sx, 0.5 + 0.004 * sy,
                             [0.1, 0.37, 0.64, 0.91]], axis=1)
        v[:4] = numpy.stack([-vscale * sx, -vscale * sy, numpy.zeros(4)],
                            axis=1)
        periodic = False
    else:
        sc = ref_taylor_green(n_side=21)
        grid = sc.grid._replace(capacity=16)
        params, periodic = sc.params, True
        x, v = numpy.asarray(sc.state.x), numpy.asarray(sc.state.v)
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


def _np(t):
    return t.detach().cpu().numpy()


def _pids(dist):
    return numpy.concatenate([_np(p) for p in dist.pid])


def _cat(ts):
    return numpy.concatenate([_np(t) for t in ts])


def _mode(continuity):
    return "continuity" if continuity else "summation"


# --------------------------------------------------------------------------
# the two packages step by step
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_run(kind, shape, n_steps, continuity=False, vscale=0.05, seed=0,
             items=()):
    """The JAX 2-D step from :func:`_inputs`: per step the numpy
    snapshots ``(x, v, pid, rho, cell_ovf, mig_ovf, dudt)``, each a list
    of shards, and the capacity."""
    grid, params, x, v, rho = _inputs(kind, seed, vscale, continuity)
    mesh = ref_make_mesh2d(shape=shape)
    dist, cap = ref_distribute(_ref_state(x, v, rho), grid, mesh)
    step = ref_make_step(grid, params, mesh, capacity=cap, use_pallas=False,
                         periodic=kind == "vortex",
                         density_mode=_mode(continuity), **dict(items))
    n_sh = shape[0] * shape[1]
    snaps = []
    for _ in range(n_steps):
        dist, aux = step(dist)
        snaps.append(tuple(
            numpy.split(numpy.asarray(a), n_sh)
            for a in (dist.x, dist.v, dist.pid, aux.rho, aux.cell_overflow,
                      aux.migrate_overflow, aux.dudt)))
    return snaps, cap


def _port_run(kind, shape, n_steps, continuity=False, vscale=0.05, seed=0,
              items=(), spill=False):
    """The port's 2-D step on the same inputs, plain pair passes
    (``spill``: the plain two-tier layout, half the capacity a tier)."""
    grid, params, x, v, rho = _inputs(kind, seed, vscale, continuity)
    pgrid = grid_from_reference(grid)
    if spill:
        pgrid = pgrid._replace(capacity=grid.capacity // 2)
    mesh = make_mesh2d(shape=shape, devices=[CPU] * (shape[0] * shape[1]))
    dist, cap = distribute_state_2d(_port_state(x, v, rho), pgrid, mesh)
    step = make_distributed2d_step_fn(
        pgrid, params_from_reference(params), mesh, capacity=cap,
        use_kernels=False, spill=spill, periodic=kind == "vortex",
        density_mode=_mode(continuity), **dict(items))
    assert step.resolved == {"use_kernels": False, "spill": spill,
                             "density_mode": _mode(continuity)}
    out = []
    for _ in range(n_steps):
        dist, aux = step(dist)
        out.append((dist, aux))
    return out, cap, x.shape[0]


def hold_step(snap, dist, aux, i, dudt=False):
    """Step ``i`` of the port against the reference's snapshot."""
    rx, rv, rpid, rrho, rcov, rmov, rdu = snap
    for d in range(len(rx)):
        numpy.testing.assert_array_equal(
            _np(dist.pid[d]), rpid[d], err_msg="step %d shard %d pid" % (i, d))
    assert [int(c) for c in aux.cell_overflow] == [int(c[0]) for c in rcov]
    assert [int(c) for c in aux.migrate_overflow] == [int(c[0]) for c in rmov]
    live = numpy.concatenate(rpid) >= 0
    cat = numpy.concatenate
    numpy.testing.assert_allclose(_cat(dist.x), cat(rx), **X_TOL,
                                  err_msg="step %d x" % i)
    numpy.testing.assert_allclose(_cat(aux.rho)[live], cat(rrho)[live],
                                  rtol=RHO_RTOL, err_msg="step %d rho" % i)
    vr = cat(rv)
    scale = numpy.abs(vr).max()
    numpy.testing.assert_allclose(_cat(dist.v) / scale, vr / scale, **V_TOL,
                                  err_msg="step %d v" % i)
    if dudt:
        dr = cat(rdu)[live]
        du_scale = numpy.abs(dr).max()
        assert du_scale > 0
        numpy.testing.assert_allclose(_cat(aux.dudt)[live] / du_scale,
                                      dr / du_scale, rtol=1e-4, atol=1e-5)


def hold_run(kind, shape, n_steps=3, continuity=False, vscale=0.05, seed=0,
             items=(), spill=False, dudt=False):
    snaps, cap = _ref_run(kind, shape, n_steps, continuity, vscale, seed,
                          items)
    out, cap_p, n = _port_run(kind, shape, n_steps, continuity, vscale, seed,
                              items, spill)
    assert cap_p == cap
    for i, (snap, (dist, aux)) in enumerate(zip(snaps, out)):
        hold_step(snap, dist, aux, i, dudt)
    return out, n


def _owner_blocks(dist, n):
    """Each particle's shard."""
    pid = _pids(dist)
    shard = numpy.repeat(numpy.arange(len(dist.pid)), dist.pid[0].shape[0])
    own = numpy.full(n, -1)
    own[pid[pid >= 0]] = shard[pid >= 0]
    return own


# --------------------------------------------------------------------------
# the mesh, the guards and the helpers
# --------------------------------------------------------------------------


def test_mesh2d_shape_and_device_order():
    """The reference's default factorisation, C order over the shape,
    the devices cut to the shape's product, repeats allowed; a 1-D mesh's
    shape is its length."""
    mesh = make_mesh2d(devices=[CPU] * 8)
    assert mesh.shape == (4, 2) and mesh.size == 8
    assert make_mesh2d(devices=[CPU] * 6).shape == (3, 2)
    cut = make_mesh2d(shape=(2, 2), devices=["cpu:%d" % i for i in range(6)])
    assert cut.devices == tuple(torch.device("cpu", i) for i in range(4))
    assert make_mesh(devices=[CPU] * 3).shape == (3,)
    assert Mesh(devices=(torch.device(CPU),) * 2).shape == (2,)
    with pytest.raises(ValueError, match="needs 6 devices, got 4"):
        make_mesh2d(shape=(3, 2), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh(devices=(torch.device(CPU),) * 2, shape=(2, 2))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_make_mesh2d_without_a_gpu_raises():
    """No silent CPU mesh: the default block meshes are the visible
    GPUs."""
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh2d()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh3d(shape=(1, 1, 1))


def test_make_mesh2d_counts_the_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh2d()
    assert mesh.shape == (2, 2)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert make_mesh3d().shape == (2, 2, 1)


def test_block_neighbours_match_the_reference_permutations():
    """(bwd, fwd) of every block: the ends of an open axis have none, a
    ring of 2 exchanges with its one neighbour both ways, a ring of 1
    with itself (tpgsd.sph.distributed2d._block_perms)."""
    shape = (3, 2)
    assert _block_neighbours((0, 0), shape, 0, False) == (None, 2)
    assert _block_neighbours((2, 1), shape, 0, False) == (3, None)
    assert _block_neighbours((0, 1), shape, 0, True) == (5, 3)
    assert _block_neighbours((1, 0), shape, 1, True) == (3, 3)
    assert _block_neighbours((1, 0), shape, 1, False) == (None, 3)
    assert _block_neighbours((0, 0, 0), (1, 1, 1), 2, True) == (0, 0)


def test_guards():
    grid, params, _x, _v, _rho = _inputs("cloud")
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh2d(shape=(4, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="multiples of the mesh"):
        make_distributed2d_step_fn(pgrid._replace(dims=(6, 4, 4)), pparams,
                                   mesh, capacity=64)
    with pytest.raises(ValueError, match="2-D mesh"):
        make_distributed2d_step_fn(pgrid, pparams,
                                   make_mesh(devices=[CPU] * 2), capacity=64)
    with pytest.raises(ValueError, match="capacity"):
        make_distributed2d_step_fn(pgrid, pparams, mesh)
    with pytest.raises(ValueError, match="3 cells along x and y"):
        make_distributed2d_step_fn(pgrid._replace(dims=(8, 2, 4)), pparams,
                                   make_mesh2d(shape=(4, 1),
                                               devices=[CPU] * 4),
                                   capacity=64, periodic=True)
    with pytest.raises(ValueError, match="density_renorm"):
        make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=64,
                                   density_mode="continuity",
                                   density_renorm=True)
    with pytest.raises(ValueError, match="use_kernels=True needs a CUDA"):
        make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=64,
                                   use_kernels=True)
    with pytest.raises(ValueError, match="2-D mesh"):
        distribute_state_2d(_port_state(_x, _v), pgrid,
                            make_mesh(devices=[CPU] * 2))
    with pytest.raises(ValueError, match="block holds 160 particles"):
        distribute_state_2d(_port_state(numpy.zeros_like(_x), _v), pgrid,
                            mesh, capacity=8)


def test_migration_helper_keeps_pids_past_2_24_exact():
    """pid rides the hop as an integer tensor: 2^24 + 1 and 2^24 + 3,
    which a float32 column rounds to 2^24 and 2^24 + 4 (the reference's
    payload, tpgsd/sph/distributed2d.py:135, :645, :661), arrive exact;
    the row that stays keeps its id too."""
    big = [2**24 + 1, 2**24 + 3, 2**24 + 5]
    assert int(numpy.float32(big[0])) == 2**24
    assert int(numpy.float32(big[1])) == 2**24 + 4
    cap = 4
    vals = torch.zeros((2, cap, 6))
    pid = torch.full((2, cap), -1, dtype=torch.int32)
    # shard 0 owns [0, 1): two rows left it forward, one stays
    vals[0, 0, 0], vals[0, 1, 0], vals[0, 2, 0] = 1.25, 1.5, 0.5
    pid[0, :3] = torch.tensor(big, dtype=torch.int32)
    rows = [(vals[d], pid[d], 0) for d in range(2)]
    neighbours = [_block_neighbours((d, 0), (2, 1), 0, False)
                  for d in range(2)]
    out = _migrate_axis(rows, 0, neighbours, [(0.0, 1.0), (1.0, 2.0)],
                        False, 0.0, 2.0, 4,
                        Exchange(Mesh(devices=(torch.device(CPU),) * 2)))
    assert out[0][1].tolist() == [-1, -1, big[2], -1]
    assert out[1][1].tolist() == [big[0], big[1], -1, -1]
    assert out[1][0][:2, 0].tolist() == [1.25, 1.5]
    assert [int(o) for _v, _p, o in out] == [0, 0]


# --------------------------------------------------------------------------
# the step against the reference's, step by step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_2d_matches_reference(continuity, spill):
    """3 steps on the (4, 2) mesh: the reference's cloud (its
    test_2d_matches_single_device and, with ``spill``, its Pallas cases
    test_2d_pallas_matches_jnp and test_2d_continuity_pallas_matches_jnp)
    step by step."""
    hold_run("cloud", (4, 2), continuity=continuity, spill=spill)


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_2d_migration_across_every_face_matches_reference(continuity):
    """The cloud at 10 m/s on the (2, 2) mesh, four of its particles
    moving across the blocks' corner: particles cross the x faces, the y
    faces and both at once (a diagonal move in one step), each hop
    staged over every shard as the reference's ppermute."""
    out, n = hold_run("movers", (2, 2), continuity=continuity, vscale=10.0,
                      seed=1, spill=continuity)
    before = _owner_blocks(_first_dist(continuity), n)
    after = _owner_blocks(out[-1][0], n)
    bi, bj = numpy.divmod(before, 2)
    ai, aj = numpy.divmod(after, 2)
    assert ((bi != ai) & (bj == aj)).any()  # x only
    assert ((bi == ai) & (bj != aj)).any()  # y only
    assert ((bi != ai) & (bj != aj)).any()  # diagonal
    pid = _pids(out[-1][0])
    assert sorted(pid[pid >= 0].tolist()) == list(range(n))


def _first_dist(continuity):
    grid, _params, x, v, rho = _inputs("movers", 1, 10.0, continuity)
    mesh = make_mesh2d(shape=(2, 2), devices=[CPU] * 4)
    return distribute_state_2d(_port_state(x, v, rho),
                               grid_from_reference(grid), mesh)[0]


def _isolated(x, v, grid, params, shape=(2, 2), rho=None, **kw):
    """Both packages' 2-D steps on a few isolated particles at capacity
    8; returns ``(port dist, port step, ref dist, ref step)``."""
    x = numpy.asarray(x, numpy.float32)
    v = numpy.asarray(v, numpy.float32)
    mesh = make_mesh2d(shape=shape, devices=[CPU] * (shape[0] * shape[1]))
    dist, _ = distribute_state_2d(_port_state(x, v, rho),
                                  grid_from_reference(grid), mesh, capacity=8)
    step = make_distributed2d_step_fn(grid_from_reference(grid),
                                      params_from_reference(params), mesh,
                                      capacity=8, **kw)
    rmesh = ref_make_mesh2d(shape=shape)
    rdist, _ = ref_distribute(_ref_state(x, v, rho), grid, rmesh, capacity=8)
    rstep = ref_make_step(grid, params, rmesh, capacity=8, **kw)
    return dist, step, rdist, rstep


def test_2d_migration_x_y_and_diagonal():
    """The reference's three isolated movers (an x face, a y face, both
    in one step): the same pids in every slot, positions x + dt v, the
    diagonal mover on block (1, 1)."""
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.5, dims=(4, 2, 2),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.1, dt=0.1, gravity=(0.0, 0.0, 0.0))
    x = [[0.95, 0.25, 0.2], [0.30, 0.45, 0.8], [0.98, 0.48, 0.5]]
    v = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]]
    dist, step, rdist, rstep = _isolated(x, v, grid, params)
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    got = collect_state(dist, 3)
    numpy.testing.assert_allclose(
        got.x, numpy.asarray(x) + 0.1 * numpy.asarray(v), rtol=1e-5)
    assert 2 in _np(dist.pid[3]).tolist()


def test_2d_continuity_diagonal_migration_carries_density():
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 8, 4),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.12, dt=0.1, gravity=(0.0, 0.0, 0.0))
    dist, step, rdist, rstep = _isolated(
        [[0.95, 0.95, 0.5]], [[1.0, 1.0, 0.0]], grid, params,
        rho=numpy.asarray([1111.5], numpy.float32),
        density_mode="continuity", delta_sph=0.0)
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    got = collect_state(dist, 1)
    numpy.testing.assert_allclose(got.x[0, :2], [1.05, 1.05], rtol=1e-5)
    numpy.testing.assert_array_equal(got.rho,
                                     numpy.asarray([1111.5], numpy.float32))
    assert 0 in _np(dist.pid[3]).tolist()


def test_2d_periodic_corner_wrap():
    """A particle crossing both periodic seams in one step arrives on the
    far-corner block with both coordinates wrapped."""
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(4, 4, 1),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.05, dt=0.1, gravity=(0.0, 0.0, 0.0))
    dist, step, rdist, rstep = _isolated(
        [[0.04, 0.06, 0.1], [0.5, 0.5, 0.15]],
        [[-1.0, -1.0, 0.0], [0.0, 0.0, 0.0]], grid, params, periodic=True)
    dist, aux = step(dist)
    rdist, _ = rstep(rdist)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    got = collect_state(dist, 2)
    numpy.testing.assert_allclose(got.x[0, :2], [0.94, 0.96], rtol=1e-5)
    assert 0 in _np(dist.pid[3]).tolist()


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_2d_periodic_matches_reference(continuity, spill):
    """The periodic vortex on the (4, 2) mesh: x and y through the rings
    (corners included), z through the pair passes' local wrap; the
    reference step by step (with ``spill`` its
    test_2d_periodic_pallas_matches_jnp)."""
    out, n = hold_run("vortex", (4, 2), continuity=continuity, spill=spill)
    assert sum(int(c) for c in out[-1][1].migrate_overflow) == 0


def test_2d_send_overflow_keeps_the_raw_coordinate():
    """Two particles cross one y face with room for one migrant a face:
    the second waits a step with its raw y, counted in migrate_overflow,
    as the reference does; on the ring the sent one arrives wrapped."""
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(4, 4, 1),
                   capacity=16)
    params = RefParams(mass=1.0, h=0.05, dt=0.1, gravity=(0.0, 0.0, 0.0))
    dist, step, rdist, rstep = _isolated(
        [[0.3, 0.97, 0.1], [0.7, 0.98, 0.1]],
        [[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], grid, params, shape=(1, 2),
        periodic=True, migrate_cap=1)
    ovf = []
    for _ in range(2):
        dist, aux = step(dist)
        rdist, raux = rstep(rdist)
        numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
        numpy.testing.assert_allclose(_cat(dist.x), numpy.asarray(rdist.x),
                                      rtol=1e-6)
        ovf.append([int(c) for c in aux.migrate_overflow])
        assert ovf[-1] == numpy.asarray(raux.migrate_overflow).tolist()
    assert sum(ovf[0]) == 1 and sum(ovf[1]) == 0
    assert set(_np(dist.pid[0]).tolist()) >= {0, 1}


# --------------------------------------------------------------------------
# degenerate meshes, the options, fixed particles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_degenerate_mesh_matches_the_ports_slabs(continuity):
    """An (8, 1) block mesh is the 8-slab decomposition: the port's 2-D
    step agrees with the port's slab step at the reference's degenerate
    tolerances (tests/test_distributed2d.py:193-215)."""
    grid, params, x, v, rho = _inputs("cloud", 3, continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = _mode(continuity)
    mesh1 = make_mesh(devices=[CPU] * 8)
    d1, cap = distribute_state(_port_state(x, v, rho), pgrid, mesh1)
    s1 = make_distributed_step_fn(pgrid, pparams, mesh1, capacity=cap,
                                  density_mode=mode)
    mesh2 = make_mesh2d(shape=(8, 1), devices=[CPU] * 8)
    d2, _ = distribute_state_2d(_port_state(x, v, rho), pgrid, mesh2,
                                capacity=cap)
    s2 = make_distributed2d_step_fn(pgrid, pparams, mesh2, capacity=cap,
                                    density_mode=mode)
    for _ in range(3):
        d1, _aux1 = s1(d1)
        d2, aux2 = s2(d2)
        numpy.testing.assert_array_equal(_pids(d2), _pids(d1))
    assert sum(int(c) for c in aux2.migrate_overflow) == 0
    g1, g2 = collect_state(d1, x.shape[0]), collect_state(d2, x.shape[0])
    numpy.testing.assert_allclose(g2.x, g1.x, **DEGENERATE_X)
    numpy.testing.assert_allclose(g2.v, g1.v, **DEGENERATE_V)


OPTION_CASES = {
    "energy": {"compute_energy": True},
    "xsph": {"xsph": 0.5},
    "density_renorm": {"density_renorm": True},
    "surface_tension": {"surface_tension": 0.5},
}


@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_2d_options_match_reference(option):
    """Each option on the (4, 2) mesh (the reference's energy,
    density_renorm and surface-tension cases; xsph too), the reference
    step by step, du/dt included."""
    items = tuple(sorted(OPTION_CASES[option].items()))
    out, _n = hold_run("cloud", (4, 2), seed=7, items=items,
                       dudt=option == "energy")
    if option == "density_renorm":
        live = _pids(out[-1][0]) >= 0
        rho0 = _cloud_params().rho0
        assert (_cat(out[-1][1].rho)[live] >= rho0 - 1e-3).all()


def test_2d_continuity_composes_the_options():
    items = (("compute_energy", True), ("surface_tension", 0.05),
             ("xsph", 0.3))
    hold_run("cloud", (2, 2), n_steps=2, continuity=True, vscale=10.0,
             seed=2, items=items, dudt=True)


def test_2d_fixed_boundary_particles():
    """n_fixed particles: sources on every block that never move or
    migrate, the reference step by step (its test_2d_fixed_boundary_
    particles)."""
    grid, params, x, v, _rho = _inputs("cloud", 11)
    n_fixed = 24
    v = v.copy()
    v[:n_fixed] = 0.0
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh2d(shape=(4, 2), devices=[CPU] * 8)
    dist, cap = distribute_state_2d(_port_state(x, v), pgrid, mesh)
    step = make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                      n_fixed=n_fixed)
    rmesh = ref_make_mesh2d(shape=(4, 2))
    rdist, _ = ref_distribute(_ref_state(x, v), grid, rmesh)
    rstep = ref_make_step(grid, params, rmesh, capacity=cap, n_fixed=n_fixed)
    for _ in range(3):
        dist, aux = step(dist)
        rdist, _ = rstep(rdist)
        numpy.testing.assert_array_equal(_pids(dist), numpy.asarray(rdist.pid))
    numpy.testing.assert_allclose(_cat(dist.x), numpy.asarray(rdist.x),
                                  **X_TOL)
    got = collect_state(dist, x.shape[0])
    numpy.testing.assert_array_equal(got.x[:n_fixed], x[:n_fixed])
    numpy.testing.assert_array_equal(got.v[:n_fixed], 0.0)


# --------------------------------------------------------------------------
# velocity_damping: the port applies it in every decomposition
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["slab", "2d", "3d"])
def test_decompositions_apply_velocity_damping(form):
    """``velocity_damping=0.9``: the port's slab, 2-D and 3-D steps
    against the JAX single-device jnp step, at the reference's
    decomposition tolerances.

    Not against the JAX decomposed steps: those kick with ``v + dt a``
    and leave the factor out (tpgsd/sph/distributed.py:738,
    distributed2d.py:610, distributed3d.py:556), while the JAX global
    step applies it (tpgsd/sph/step.py:891).  The port's decompositions
    integrate through the global step's one ``_integrate``, so they
    agree with the global step, and the 10% a step the reference's
    decompositions drop is far outside these tolerances."""
    grid, _params, x, v, _rho = _inputs("cloud", 4, vscale=1.0)
    params = _cloud_params()._replace(velocity_damping=0.9)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    ref_step = ref_make_step_fn(grid, params)
    rs = _ref_state(x, v)
    for _ in range(3):
        rs, _ = ref_step(rs)
    if form == "slab":
        mesh = make_mesh(devices=[CPU] * 4)
        dist, cap = distribute_state(_port_state(x, v), pgrid, mesh)
        step = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap)
    elif form == "2d":
        mesh = make_mesh2d(shape=(4, 2), devices=[CPU] * 8)
        dist, cap = distribute_state_2d(_port_state(x, v), pgrid, mesh)
        step = make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=cap)
    else:
        mesh = make_mesh3d(shape=(2, 2, 2), devices=[CPU] * 8)
        dist, cap = distribute_state_3d(_port_state(x, v), pgrid, mesh)
        step = make_distributed3d_step_fn(pgrid, pparams, mesh, capacity=cap)
    for _ in range(3):
        dist, _aux = step(dist)
    got = collect_state(dist, x.shape[0])
    numpy.testing.assert_allclose(got.x, numpy.asarray(rs.x), **GLOBAL_X)
    numpy.testing.assert_allclose(got.v, numpy.asarray(rs.v), **GLOBAL_V)
    # the reference's decompositions leave the factor out
    undamped = numpy.asarray(ref_make_step_fn(grid, _cloud_params())(
        _ref_state(x, v))[0].v)
    assert numpy.abs(numpy.asarray(rs.v) - undamped).max() > 0.1


# --------------------------------------------------------------------------
# the adaptive step
# --------------------------------------------------------------------------


def _adaptive_pair(continuity, shape=(4, 2), seed=11, **kw):
    grid, params, x, v, rho = _inputs("cloud", seed, continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mesh = make_mesh2d(shape=shape, devices=[CPU] * (shape[0] * shape[1]))
    dist, cap = distribute_state_2d(_port_state(x, v, rho), pgrid, mesh)
    mode = _mode(continuity)
    fixed = make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                       density_mode=mode)
    adaptive = make_adaptive_distributed2d_step_fn(
        pgrid, pparams, mesh, capacity=cap, density_mode=mode, **kw)
    return dist, fixed, adaptive, params


@pytest.mark.parametrize("continuity", [False, True],
                         ids=["summation", "continuity"])
def test_2d_adaptive_matches_fixed_at_same_dt(continuity):
    dist, fixed, adaptive, params = _adaptive_pair(continuity)
    assert adaptive.resolved == fixed.resolved
    df, da = dist, dist
    dt = torch.tensor(params.dt, dtype=torch.float32)
    for _ in range(3):
        df, _ = fixed(df)
        da, _, _dt_next = adaptive(da, dt)
    for f, a in zip(df, da):
        if f is not None:
            assert all(torch.equal(tf, ta) for tf, ta in zip(f, a))


def test_2d_adaptive_controller_matches_reference():
    """dt_next of one adaptive step equals the JAX 2-D controller's
    within 1e-7 relative."""
    grid, params, x, v, _rho = _inputs("cloud", 12)
    dist, _fixed, adaptive, _ = _adaptive_pair(False, seed=12, cfl=0.3)
    _, _, dt_next = adaptive(dist, torch.tensor(params.dt,
                                                dtype=torch.float32))
    rmesh = ref_make_mesh2d(shape=(4, 2))
    rdist, cap = ref_distribute(_ref_state(x, v), grid, rmesh)
    rstep = ref_make_adaptive(grid, params, rmesh, capacity=cap, cfl=0.3,
                              use_pallas=False)
    _, _, rdt = rstep(rdist, jnp.float32(params.dt))
    numpy.testing.assert_allclose(float(dt_next), float(rdt), rtol=1e-7)


def test_2d_adaptive_rollout():
    """run_adaptive on the (2, 2) mesh: finite, every particle once, time
    advanced by the dts taken."""
    dist, _fixed, adaptive, params = _adaptive_pair(False, shape=(2, 2),
                                                    seed=13)
    out, dt, t = run_adaptive(adaptive, dist, params.dt, 8)
    assert 0.0 < float(dt) <= float(numpy.float32(params.dt))
    assert 0.0 < float(t) <= 8 * params.dt + 1e-9
    pid = _pids(out)
    assert sorted(pid[pid >= 0].tolist()) == list(range(160))
    got = collect_state(out, 160)
    assert numpy.isfinite(got.x).all() and numpy.isfinite(got.v).all()


def test_2d_scan_simulate_with_dumps(tmp_path):
    """The port's scan_simulate over the 2-D step, a frame every 2 steps
    through concat_shards: the last frame is the final state."""
    import tpgsd_torch.hoomd
    from tpgsd_torch.io_runtime import JitDumpChannel, scan_simulate
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph.distributed import concat_shards

    dist, fixed, _adaptive, _params = _adaptive_pair(False, shape=(2, 2),
                                                     seed=13)
    path = tmp_path / "dist2d_scan.gsd"
    channel = JitDumpChannel(ShardedFrameWriter(path, comm=SingleComm()),
                             ["particles/position", "particles/density"])
    final = scan_simulate(
        fixed, dist, n_steps=3, channel=channel,
        frame_of=lambda s, aux: [concat_shards(s.x), concat_shards(aux.rho)],
        every=2)
    channel.close()
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 2
        numpy.testing.assert_array_equal(traj[1].particles.position,
                                         _cat(final.x))
    pid = _pids(final)
    assert sorted(pid[pid >= 0].tolist()) == list(range(160))


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer_form,continuity",
                         [("2d", False), ("2d", True), ("slab", False)],
                         ids=["2d-summation", "2d-continuity", "slab"])
def test_resume_distributed2d_onto_another_shape(tmp_path, writer_form,
                                                 continuity):
    """2 frames from a (2, 2) run (or a 2-slab run) resumed onto (4, 2):
    the same pids in every slot, positions (and carried density) as the
    JAX resume_distributed2d of the same file; a step and an appended
    frame."""
    import tpgsd_torch.hoomd
    from tpgsd.sph.checkpoint import resume_distributed2d as ref_resume
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph import resume_distributed2d

    grid, params, x, v, rho = _inputs("cloud", 5, vscale=1.0,
                                      continuity=continuity)
    pgrid, pparams = grid_from_reference(grid), params_from_reference(params)
    mode = _mode(continuity)
    if writer_form == "slab":
        mesh = make_mesh(devices=[CPU] * 2)
        dist, cap = distribute_state(_port_state(x, v, rho), pgrid, mesh)
        step = make_distributed_step_fn(pgrid, pparams, mesh, capacity=cap,
                                        density_mode=mode)
    else:
        mesh = make_mesh2d(shape=(2, 2), devices=[CPU] * 4)
        dist, cap = distribute_state_2d(_port_state(x, v, rho), pgrid, mesh)
        step = make_distributed2d_step_fn(pgrid, pparams, mesh, capacity=cap,
                                          density_mode=mode)
    n = x.shape[0]
    path = str(tmp_path / "dist2d.gsd")
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

    mesh42 = make_mesh2d(shape=(4, 2), devices=[CPU] * 8)
    res, rcap, last, w = resume_distributed2d(path, pgrid, mesh42,
                                              density_mode=mode)
    rdist, rrcap, rlast, rw = ref_resume(path, grid,
                                         ref_make_mesh2d(shape=(4, 2)),
                                         density_mode=mode)
    rw.close()
    assert (rcap, last) == (rrcap, rlast) == (rcap, 1)
    numpy.testing.assert_array_equal(_pids(res), numpy.asarray(rdist.pid))
    numpy.testing.assert_array_equal(_cat(res.x), numpy.asarray(rdist.x))
    if continuity:
        numpy.testing.assert_array_equal(_cat(res.rho),
                                         numpy.asarray(rdist.rho))
    step42 = make_distributed2d_step_fn(pgrid, pparams, mesh42, capacity=rcap,
                                        density_mode=mode)
    res, aux = step42(res)
    assert sum(int(c) for c in aux.migrate_overflow) == 0
    got = collect_state(res, n)
    w.write_frame({"particles/position": got.x,
                   "configuration/step": numpy.asarray([2], numpy.uint64)})
    w.close()
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 3
        numpy.testing.assert_array_equal(traj[2].particles.position, got.x)
