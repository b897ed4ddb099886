"""The torch port's async frame dump into the port's own writer, and the
port's independence from JAX and from the JAX package."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy
import pytest
import torch

import tpgsd_torch.hoomd
from tpgsd_torch.io_runtime import AsyncDumpRunner, run_dump_loop
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

REPO = Path(__file__).resolve().parent.parent


def _writer(path):
    return ShardedFrameWriter(str(path), application="test", comm=SingleComm())


def test_runner_snapshots_its_input(tmp_path):
    """Torch tensors are mutable: a frame must be the tensor's value at
    submit time, whatever the caller writes to it afterwards."""
    path = tmp_path / "snap.gsd"
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    want = x.clone()
    with AsyncDumpRunner(_writer(path), depth=1) as dump:
        for i in range(3):
            dump.submit({"particles/position": x}, step=i)
            x.mul_(0)
            x += float(i + 1)
    with tpgsd_torch.hoomd.open(str(path), mode="r") as traj:
        frames = [f.particles.position for f in traj]
    numpy.testing.assert_array_equal(frames[0], want.numpy())
    numpy.testing.assert_array_equal(frames[1], numpy.full((10, 3), 1.0))
    numpy.testing.assert_array_equal(frames[2], numpy.full((10, 3), 2.0))


class _RecordingWriter:
    """Keeps the arrays it is asked to write."""

    def __init__(self):
        self.frames = []

    def write_frame(self, chunks, step=None):
        self.frames.append(chunks)

    def flush(self):
        pass

    def close(self):
        pass


def test_runner_takes_owned_host_tensors_without_a_copy():
    """``submit(owned=True)`` queues a host tensor itself (the slab
    channel hands over each completed frame so), and the default still
    snapshots it."""
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    rec = _RecordingWriter()
    with AsyncDumpRunner(rec) as dump:
        dump.submit({"particles/position": x}, step=0, owned=True)
        dump.submit({"particles/position": x}, step=1)
        dump.flush()
    owned, copied = (f["particles/position"] for f in rec.frames)
    assert numpy.shares_memory(owned, x.numpy())
    assert not numpy.shares_memory(copied, x.numpy())
    numpy.testing.assert_array_equal(copied, x.numpy())


def test_dump_stats_are_populated(tmp_path):
    x = torch.ones((1000, 3))
    with AsyncDumpRunner(_writer(tmp_path / "stats.gsd")) as dump:
        for i in range(4):
            dump.submit({"particles/position": x, "particles/density": x[:, 0]},
                        step=i)
        dump.flush()
    s = dump.stats
    assert s.frames == 4
    assert s.bytes == 4 * (1000 * 3 * 4 + 1000 * 4)
    assert s.write_seconds > 0
    assert s.write_mb_s == pytest.approx(s.bytes / 1e6 / s.write_seconds)
    for gone in ("effective_mb_s", "overlap_efficiency", "wall_seconds"):
        assert not hasattr(s, gone)


class _FailingWriter:
    def write_frame(self, chunks, step=None):
        raise OSError("disk full")

    def flush(self):
        pass

    def close(self):
        pass


def test_writer_error_surfaces_at_the_next_call():
    dump = AsyncDumpRunner(_FailingWriter())
    dump.submit({"particles/position": torch.zeros((2, 3))}, step=0)
    with pytest.raises(RuntimeError, match="writer failed"):
        dump.flush()
    with pytest.raises(ValueError, match="closed"):
        dump.submit({"particles/position": torch.zeros((2, 3))})
    dump.close()


def test_run_dump_loop_writes_every_step(tmp_path):
    path = tmp_path / "loop.gsd"

    def step(state):
        state = state + 1.0
        return state, (state.sum(),)

    final, stats = run_dump_loop(
        step, torch.zeros((5, 3)), _writer(path), 3,
        lambda s, aux, i: {"particles/position": s},
    )
    assert stats.frames == 3 and float(final[0, 0]) == 3.0
    with tpgsd_torch.hoomd.open(str(path), mode="r") as traj:
        assert [float(f.particles.position[0, 0]) for f in traj] == [1.0, 2.0, 3.0]


_STANDALONE = textwrap.dedent(
    """
    import sys
    # any import of jax or of the JAX package now raises ImportError
    sys.modules["jax"] = None
    sys.modules["tpgsd"] = None
    import os, tempfile
    import numpy
    import tpgsd_torch.hoomd
    from tpgsd_torch.entry import entry
    from tpgsd_torch.io_runtime import AsyncDumpRunner
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    step, (state,) = entry(n_side=6, device="cpu", density_mode="continuity")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.gsd")
        w = ShardedFrameWriter(path, application="t", comm=SingleComm())
        with AsyncDumpRunner(w) as dump:
            for i in range(2):
                state, (rho, p, ov) = step(state)
                dump.submit({"particles/position": state.x,
                             "particles/velocity": state.v,
                             "particles/density": state.rho}, step=i)
        with tpgsd_torch.hoomd.open(path, mode="r") as traj:
            assert len(traj) == 2
            last = traj[-1].particles
            assert numpy.array_equal(last.density, state.rho.numpy())
            assert numpy.array_equal(last.position, state.x.numpy())
    import tpgsd_torch.pypgsd
    from tpgsd_torch.io_runtime import SlabDumpChannel
    from tpgsd_torch.sph import dam_break, make_slab_step_fn
    db = dam_break(n_side=9, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slab.gsd")
        chan = SlabDumpChannel(
            ShardedFrameWriter(path, application="t", comm=SingleComm()),
            n=db.n, n_slabs=2, keys=("position",))
        slab = make_slab_step_fn(db.grid, db.params, 2,
                                 slab_emit=chan.slab_emit, device="cpu")
        moved, _aux = slab(db.state, chan.dump(0))
        chan.close()
        assert tpgsd_torch.pypgsd.verify(path, deep=True)["ok"]
        with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
            got = f.read_chunk(0, "particles/position")
        assert numpy.array_equal(got, moved.x.numpy())
    from tpgsd_torch.sph import make_step_fn, taylor_green
    vortex = taylor_green(n_side=12, device="cpu")
    spin = make_step_fn(vortex.grid, vortex.params, periodic=True, device="cpu")
    moved, _aux = spin(vortex.state)
    assert moved.x.shape == vortex.state.x.shape
    import torch.distributed as dist
    from tpgsd_torch.parallel import ComposedFrameWriter, launch, worker
    from tpgsd_torch.parallel.exchange import Exchange
    from tpgsd_torch.parallel import make_mesh
    comm = launch.init_process_group(0, 1, launch.free_port())
    assert not Exchange(make_mesh(devices=["cpu"] * 2, comm=comm)).spans_processes
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "composed.gsd")
        with ComposedFrameWriter(path, application="t", comm=comm) as w:
            w.write_frame({"particles/position": moved.x})
        assert tpgsd_torch.pypgsd.verify(path, deep=True)["ok"]
    dist.destroy_process_group()
    assert callable(worker.drive) and callable(worker.main)
    assert sys.modules["jax"] is None and sys.modules["tpgsd"] is None
    assert not [m for m in sys.modules if m.startswith(("jax.", "tpgsd."))]
    print("STANDALONE_OK")
    """
)


def test_port_runs_without_jax():
    """The continuity entry with its dump and read-back, the slab step
    streaming a frame through ``SlabDumpChannel`` with its fsck, a
    periodic step, and a one-process group's ``TorchProcessComm`` under
    the exchange seam and the composing writer, with the spawned
    workers' module imported, in a process where neither ``jax`` nor
    ``tpgsd`` can be imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _STANDALONE], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE_OK" in proc.stdout


def test_port_sources_import_no_jax_and_no_jax_package_modules():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|tpgsd)(\.|\s|$)", re.M
    )
    sources = sorted((REPO / "tpgsd_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "examples" / "dam_break_demo_torch.py"]
    assert len(sources) > 20
    # the multi-process modules, and the worker that chip_smoke.py and
    # the multi-process tests spawn, are scanned too
    for module in ("comm", "compose_io", "exchange", "launch", "worker"):
        assert REPO / "tpgsd_torch" / "parallel" / (module + ".py") in sources
    # and the command line, which with the file layers it reads through
    # imports no torch either
    assert REPO / "tpgsd_torch" / "__main__.py" in sources
    offending = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offending == []
    numpy_only = [REPO / "tpgsd_torch" / name for name in (
        "__init__.py", "__main__.py", "fl.py", "hoomd.py", "pypgsd.py",
        "vtu.py", "version.py", "format/structs.py", "format/validate.py",
        "io/backend.py", "io/native/__init__.py", "utils/trace.py")]
    torch_import = re.compile(r"^\s*(import|from)\s+torch(\.|\s|$)", re.M)
    assert [str(p) for p in numpy_only
            if torch_import.search(p.read_text())] == []
