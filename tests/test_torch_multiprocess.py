"""The port's file layer over real OS processes: the twin of the file
cases of tests/test_multiprocess.py.

2 and 4 processes (``tpgsd_torch.parallel.launch.spawn`` of
``python -m tpgsd_torch.parallel.worker``) coordinate through
``TorchProcessComm`` over Gloo: striped writes of uneven stripes, the
compose-on-commit writer, the controller killed mid-frame, and the pod
shape (2 processes x 2 CPU shards each: several shards a process written
and read back, and the slab SPH step with local and remote exchanges in
one step and its dump).  Every worker imports ``tpgsd_torch``, numpy and
torch only, and checks that neither ``jax`` nor ``tpgsd`` was loaded.
Every file written by several processes is byte-equal to the file one
process writes from the same frames under ``SingleComm``.  Each spawn has
its own deadline, and a failing worker takes the others down.
"""

import signal

import jax
import jax.numpy as jnp
import numpy
import numpy.testing
import pytest
import torch

import tpgsd_torch.fl
import tpgsd_torch.pypgsd
from tpgsd.sph import SPHParams as RefParams
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph.cells import CellGrid as RefGrid
from tpgsd_torch.parallel import (
    ComposedFrameWriter,
    ShardedFrameWriter,
    SingleComm,
    launch,
    worker,
)
from tpgsd_torch.sph.convert import grid_from_reference, params_from_reference

#: seconds a spawn of workers may take, start-up included
SPAWN_TIMEOUT_S = 120
#: the reference's multi-process tolerances (tests/test_multiprocess.py)
MP_X = dict(rtol=5e-4, atol=5e-5)
MP_V = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spawn(tmp_path, runs, nprocs):
    worker.write_case(tmp_path, runs)
    return launch.spawn(tmp_path, nprocs, SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_striped_write(tmp_path, nprocs):
    """N processes stripe uneven rows (rank r owns 3 + r) into one file,
    byte-equal to one process writing the whole rows."""
    path = str(tmp_path / "mp.gsd")
    _spawn(tmp_path, [{"kind": "striped", "path": path}], nprocs).check()
    total = sum(3 + r for r in range(nprocs))
    data = numpy.arange(total, dtype=numpy.float64)
    one = str(tmp_path / "one.gsd")
    f = tpgsd_torch.fl.PGSDFile(one, "w", application="mp", schema="none",
                                schema_version=(1, 0), comm=SingleComm())
    for frame in range(2):
        f.write_chunk("step", numpy.array([frame], numpy.uint64),
                      write_all=False)
        f.write_chunk("d", data + frame, write_all=True)
        f.end_frame()
    f.close()
    assert open(path, "rb").read() == open(one, "rb").read()
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 2
        numpy.testing.assert_array_equal(f.read_chunk(1, "d"), data + 1)
        assert f.read_chunk(1, "step")[0] == 1


def test_composed_writer_multiprocess(tmp_path):
    """4 processes spill their own rows privately; the controller
    composes one file, byte-equal to the one process's, fsck-clean."""
    nprocs, rows = 4, 4
    path = str(tmp_path / "composed.gsd")
    _spawn(tmp_path, [{"kind": "composed", "path": path, "rows": rows}],
           nprocs).check()
    whole = [numpy.concatenate(parts) for parts in zip(
        *(worker.log_frames(r, nprocs, rows, 3) for r in range(nprocs)))]
    numpy.testing.assert_array_equal(
        whole[0], numpy.arange(rows * nprocs, dtype=numpy.float64) * 10)
    one = str(tmp_path / "one.gsd")
    with ComposedFrameWriter(one, schema="none", schema_version=(1, 0),
                             comm=SingleComm()) as w:
        for i, d in enumerate(whole):
            w.write_frame({"log/d": d}, step=i)
    assert open(path, "rb").read() == open(one, "rb").read()
    report = tpgsd_torch.pypgsd.verify(path, deep=True)
    assert report["ok"], report["errors"]


def test_kill_controller_mid_frame(tmp_path):
    """The controller (rank 0, which also hosts the group's store) is
    killed after its frame-3 bytes are written but before any index
    commit; the survivors are torn down.  The file reopens at exactly 3
    frames."""
    nprocs = 4
    path = str(tmp_path / "killed.gsd")
    done = _spawn(tmp_path, [{"kind": "kill", "path": path}], nprocs)
    assert done.returncodes[0] == -signal.SIGKILL, done.outputs[0][-2000:]
    assert not done.timed_out
    data = numpy.arange(4 * nprocs, dtype=numpy.float64)
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 3
        for frame in range(3):
            numpy.testing.assert_array_equal(f.read_chunk(frame, "d"),
                                             data + frame)
        assert not f.chunk_exists(3, "d")
    report = tpgsd_torch.pypgsd.verify(path, deep=True)
    assert report["ok"], report["errors"]


def test_pod_shape_write_read_sph(tmp_path):
    """2 processes x 2 CPU shards each: each process writes only its own
    shards of a global array and reads them back in the same layout;
    then the slab step over the 4-shard mesh, whose every step mixes
    exchanges within a process and across processes, dumps 2 frames.
    The shards equal the single-controller step's bit for bit, the
    collected state the JAX single-device step's at the reference's
    tolerances, and the dump file the one process's byte for byte."""
    nprocs = 2
    ref_grid = RefGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25,
                       dims=(4 * nprocs, 4, 4), capacity=16)
    rng = numpy.random.RandomState(7)
    n = 40 * nprocs
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= nprocs
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    ref_params = RefParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                           gravity=(0.0, 0.0, -9.81))
    step_ref = jax.jit(ref_make_step_fn(ref_grid, ref_params,
                                        use_pallas=False))
    s_ref = RefState(x=jnp.asarray(x), v=jnp.asarray(v))
    for _ in range(2):
        s_ref, _aux = step_ref(s_ref)

    io_path = str(tmp_path / "pod.gsd")
    traj = str(tmp_path / "pod_traj.gsd")
    runs = [
        {"kind": "pod_io", "path": io_path, "rows": 5,
         "devices": ["cpu", "cpu"]},
        {"kind": "step", "form": "slab", "devices": ["cpu", "cpu"],
         "grid": grid_from_reference(ref_grid),
         "params": params_from_reference(ref_params),
         "state": (x, v, None), "steps": 2, "frames": 2,
         "write": {"sharded": traj}, "collect": True},
    ]
    singles, results = worker.over_processes(tmp_path, runs, nprocs,
                                             SPAWN_TIMEOUT_S)
    assert [res[1]["mesh"] for res in results] == [(0, 1), (2, 3)]
    for res in results:
        assert res[1]["overflow"] == (0, 0)
        got = res[1]["collected"]
        numpy.testing.assert_allclose(got.x, numpy.asarray(s_ref.x), **MP_X)
        numpy.testing.assert_allclose(got.v, numpy.asarray(s_ref.v), **MP_V)
    assert open(traj, "rb").read() == open(traj + ".one", "rb").read()
    total = 5 * 2 * nprocs
    data = numpy.arange(total * 2, dtype=numpy.float64).reshape(total, 2)
    with tpgsd_torch.pypgsd.PGSDFile(open(io_path, "rb")) as f:
        assert f.nframes == 2
        for frame in range(2):
            numpy.testing.assert_array_equal(f.read_chunk(frame, "log/d"),
                                             data + frame)
    with tpgsd_torch.pypgsd.PGSDFile(open(traj, "rb")) as f:
        pid = f.read_chunk(1, "log/pid")
        assert pid.shape == (4 * singles[1]["capacity"],)
        assert sorted(pid[pid >= 0].tolist()) == list(range(n))
    for path in (io_path, traj):
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        assert report["ok"], report["errors"]


def test_one_process_group_comm(tmp_path):
    """``TorchProcessComm`` in a one-process Gloo group: every collective
    returns this process's value, and a writer over it is byte-equal to
    the one over ``SingleComm``."""
    import torch.distributed as dist

    from tpgsd_torch.parallel import TorchProcessComm

    with pytest.raises(RuntimeError, match="init_process_group"):
        TorchProcessComm()
    comm = launch.init_process_group(0, 1, launch.free_port())
    try:
        assert (comm.rank, comm.size) == (0, 1)
        assert comm.allgather({"a": 1}) == [{"a": 1}]
        assert comm.bcast(["names"]) == ["names"]
        assert comm.allreduce_sum(3) == 3 and comm.allreduce_max(4) == 4
        comm.barrier()
        frames = [{"particles/position": numpy.full((6, 3), i, numpy.float32)}
                  for i in range(2)]
        for name, c in (("group.gsd", comm), ("single.gsd", SingleComm())):
            with ShardedFrameWriter(str(tmp_path / name), application="t",
                                    comm=c) as w:
                for i, fr in enumerate(frames):
                    w.write_frame(fr, step=i)
        assert ((tmp_path / "group.gsd").read_bytes()
                == (tmp_path / "single.gsd").read_bytes())
    finally:
        dist.destroy_process_group()
