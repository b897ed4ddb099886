"""The port's decomposed SPH steps over real OS processes, one a rank:
the twin of the SPH cases of tests/test_multiprocess.py.

Each case spawns 2, 4 or 8 workers (``tpgsd_torch.parallel.worker``,
Gloo, one CPU shard a process), so every halo plane, migrant and CFL
maximum that crosses a shard boundary crosses a process boundary.  Each
worker holds its shards, at every step, bit for bit to the port's
single-controller decomposed step on the same mesh shape, run here in
the parent (same ``pid`` in every slot; x, v and rho equal).  The parent
then holds the workers' collected state (``collect_state(..., comm)``,
gathered on every rank) to the JAX package's single-device jnp step on
the same seeded numpy inputs, at the reference's multi-process
tolerances (tests/test_multiprocess.py: x rtol 5e-4 atol 5e-5, v rtol
5e-3 atol 5e-3, carried rho rtol 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy
import numpy.testing
import pytest
import torch

import tpgsd_torch.pypgsd
from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_adaptive_step_fn as ref_make_adaptive_step_fn
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph.cells import CellGrid as RefGrid
from tpgsd.sph.cells import build_cells as ref_build_cells
from tpgsd_torch.parallel import worker
from tpgsd_torch.sph.convert import grid_from_reference, params_from_reference

#: seconds a spawn of workers may take, start-up included
SPAWN_TIMEOUT_S = 180
MP_X = dict(rtol=5e-4, atol=5e-5)
MP_V = dict(rtol=5e-3, atol=5e-3)
MP_RHO_RTOL = 5e-4
#: dt_next of the port against the JAX package's: the CFL maxima are
#: sums of the same pair forces, rounded in another order
DT_RTOL = 1e-4
SHAPES = {"slab": None, "2d": (2, 2), "3d": (2, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(dims, n=160, seed=7, vscale=0.05):
    """The reference workers' random cloud: ``n`` particles on a
    ``dims`` grid of 0.25 cells (stretched along x on the (8, 4, 4)
    grid), velocities N(0, vscale^2) (0.05 m/s there; 5 m/s carries
    particles across the shards' faces in 3 steps)."""
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=dims,
                   capacity=16)
    rng = numpy.random.RandomState(seed)
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= dims[0] / 4
    v = (rng.randn(n, 3) * vscale).astype(numpy.float32)
    params = RefParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    return grid, params, x, v


def _run(form, grid, params, x, v, rho=None, steps=3, **extra):
    return dict({"kind": "step", "form": form, "shape": SHAPES[form],
                 "devices": ["cpu"], "grid": grid_from_reference(grid),
                 "params": params_from_reference(params),
                 "state": (x, v, rho), "steps": steps, "collect": True},
                **extra)


def _reference(grid, params, x, v, steps, rho=None, **kw):
    step = jax.jit(ref_make_step_fn(grid, params, use_pallas=False, **kw))
    s = RefState(x=jnp.asarray(x), v=jnp.asarray(v),
                 rho=None if rho is None else jnp.asarray(rho))
    for _ in range(steps):
        s, _aux = step(s)
    return s


def _blocks(x, grid, shape):
    """The shard that owns each of positions ``x`` on a mesh of
    ``shape``."""
    ids = [numpy.clip(((x[:, a] - grid.lo[a])
                       // (grid.dims[a] // s * grid.cell_size)).astype(int),
                      0, s - 1) for a, s in enumerate(shape)]
    return numpy.ravel_multi_index(ids, shape)


def _crossed(run, nprocs, collected):
    """Particles whose shard changed over the run."""
    shape = run["shape"] or (nprocs,)
    x0 = run["state"][0]
    return int((_blocks(x0, run["grid"], shape)
                != _blocks(collected.x, run["grid"], shape)).sum())


def _hold(tmp_path, runs, nprocs, refs, crossing=False):
    """Spawn the case (each worker holds its shards to the single
    controller's) and hold every rank's collected state of run ``j`` to
    ``refs[j]``, the JAX step's state; with ``crossing``, particles must
    have changed shard (and so process)."""
    singles, results = worker.over_processes(tmp_path, runs, nprocs,
                                             SPAWN_TIMEOUT_S)
    n = len(runs[0]["state"][0])
    for j, ref in enumerate(refs):
        assert sorted(d for res in results for d in res[j]["mesh"]) == list(
            range(nprocs))
        for res in results:
            assert res[j]["overflow"] == (0, 0)
            got = res[j]["collected"]
            numpy.testing.assert_array_equal(got.x, results[0][j]["collected"].x)
            numpy.testing.assert_allclose(got.x, numpy.asarray(ref.x), **MP_X)
            numpy.testing.assert_allclose(got.v, numpy.asarray(ref.v), **MP_V)
            if ref.rho is not None:
                numpy.testing.assert_allclose(got.rho, numpy.asarray(ref.rho),
                                              rtol=MP_RHO_RTOL)
        assert singles[j]["collected"].x.shape == (n, 3)
        if crossing:
            assert _crossed(runs[j], nprocs, results[0][j]["collected"]) > 0
    return singles, results


def test_slab_step_on_2_processes(tmp_path):
    """The slab step with its 2 shards in 2 processes: each halo plane
    and migrant crosses the process boundary."""
    grid, params, x, v = _cloud((8, 4, 4), vscale=5.0)
    _hold(tmp_path, [_run("slab", grid, params, x, v)], 2,
          [_reference(grid, params, x, v, 3)], crossing=True)


def test_2d_step_on_4_processes(tmp_path):
    """The (2, 2) block step, one block a process: both halo axes and
    both migration hops cross processes."""
    grid, params, x, v = _cloud((8, 4, 4), vscale=5.0)
    _hold(tmp_path, [_run("2d", grid, params, x, v)], 4,
          [_reference(grid, params, x, v, 3)], crossing=True)


def test_3d_step_on_8_processes(tmp_path):
    """The (2, 2, 2) block step, one block a process: all three halo
    axes and migration hops cross processes."""
    grid, params, x, v = _cloud((4, 4, 4), vscale=5.0)
    _hold(tmp_path, [_run("3d", grid, params, x, v)], 8,
          [_reference(grid, params, x, v, 3)], crossing=True)


def test_2d_dump_cycle_on_4_processes(tmp_path):
    """Simulate and dump over 4 processes: each writes only its own
    shards of position, velocity and pid (``frame_shards``) through
    ``ShardedFrameWriter`` and ``ComposedFrameWriter`` over
    ``TorchProcessComm``.  Both files are byte-equal to the one process's,
    hold every particle exactly once in each frame and pass the deep
    fsck."""
    grid, params, x, v = _cloud((8, 4, 4))
    paths = {"sharded": str(tmp_path / "cycle.gsd"),
             "composed": str(tmp_path / "cycle_composed.gsd")}
    run = _run("2d", grid, params, x, v, steps=2, frames=2, write=paths)
    singles, _results = _hold(tmp_path, [run], 4,
                              [_reference(grid, params, x, v, 2)])
    cap = singles[0]["capacity"]
    for path in paths.values():
        assert open(path, "rb").read() == open(path + ".one", "rb").read()
        with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
            assert f.nframes == 2
            for frame in range(2):
                pos = f.read_chunk(frame, "particles/position")
                pid = f.read_chunk(frame, "log/pid")
                assert pos.shape == (4 * cap, 3)
                assert sorted(pid[pid >= 0].tolist()) == list(range(len(x)))
                assert numpy.isfinite(pos[pid >= 0]).all()
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        assert report["ok"], report["errors"]


@pytest.mark.parametrize("mode", ["summation", "continuity"])
def test_spill_step_on_2_processes(tmp_path, mode):
    """The two-tier spill layout (the plain spill passes) over 2
    processes, the reference's dense-corner cloud: at least 10 cells past
    the K = 24 main tier, none past 48.  The JAX step runs one tier of 48
    slots."""
    rng = numpy.random.default_rng(3)
    n = 2400
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(numpy.float32)
    x[:, 0] *= 2.0
    for a in range(3):
        x[:140, a] = rng.uniform(0.02, 0.51, 140)
    v = (rng.normal(size=(n, 3)) * 0.05).astype(numpy.float32)
    grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                   capacity=24)
    params = RefParams(mass=0.8, h=0.12, dt=1e-4, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    grid48 = grid._replace(capacity=48)
    occ = numpy.bincount(numpy.asarray(ref_build_cells(jnp.asarray(x),
                                                       grid48).cid),
                         minlength=grid.n_cells)
    assert (occ > 24).sum() >= 10 and occ.max() <= 44
    rho, kw = None, {}
    if mode == "continuity":
        rho = numpy.asarray(ref_init_density(
            RefState(x=jnp.asarray(x), v=jnp.asarray(v)), grid48, params).rho)
        kw["density_mode"] = "continuity"
    run = _run("slab", grid, params, x, v, rho=rho, steps=2,
               kw=dict(kw, spill=True))
    _hold(tmp_path, [run], 2,
          [_reference(grid48, params, x, v, 2, rho=rho, **kw)])


def test_adaptive_slab_step_on_2_processes(tmp_path):
    """The CFL-adaptive slab step over 2 processes: the maxima meet in
    one all_reduce, every rank steps with the same dt, bit-identical to
    the single-controller adaptive step (held in the workers), and the
    dts and state follow the JAX single-device adaptive step."""
    grid, params, x, v = _cloud((8, 4, 4), vscale=5.0)
    run = _run("slab", grid, params, x, v, adaptive=True)
    step = jax.jit(ref_make_adaptive_step_fn(grid, params, use_pallas=False))
    s = RefState(x=jnp.asarray(x), v=jnp.asarray(v))
    dt, dts = jnp.float32(params.dt), []
    for _ in range(3):
        s, _aux, dt = step(s, dt)
        dts.append(float(dt))
    singles, results = _hold(tmp_path, [run], 2, [s], crossing=True)
    got = [float(numpy.uint32(b).view(numpy.float32))
           for b in singles[0]["dts"]]
    assert got[0] < float(params.dt)  # the controller bound
    numpy.testing.assert_allclose(got, dts, rtol=DT_RTOL)
    for res in results:
        assert res[0]["dts"] == singles[0]["dts"]
