"""The torch port's per-slab frame streaming
(``make_slab_step_fn(slab_emit=...)`` with ``SlabDumpChannel``), one test
for each of tests/test_slab_dump.py (the reference's ``io_callback``
probe has no counterpart: emission is a side stream and a host thread).

The streamed frames must equal the port's post-step state bit for bit:
the emitted windows are integrated by the same helper as the step's
epilogue, and slab-ordered delivery makes a later slab's rows overwrite
an earlier slab's halo rows.  The same input through the JAX package's
channel gives frames within tests/test_bigstep.py's tolerances, and both
packages' ``pypgsd.verify(deep=True)`` pass on the port's file.  On the
CPU the copy into the ring is synchronous; the host thread and the ring
are the same as on the card (tests/test_torch_cuda.py runs the stream).
"""

import os
import tempfile
import threading

import jax
import numpy
import numpy.testing
import pytest
import torch

import tpgsd.pypgsd
import tpgsd_torch.pypgsd
from tpgsd.io_runtime import SlabDumpChannel as RefSlabDumpChannel
from tpgsd.parallel import ShardedFrameWriter as RefShardedFrameWriter
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import hydrostatic_tank as ref_hydrostatic_tank
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_slab_step_fn as ref_make_slab_step_fn
from tpgsd_torch.io_runtime import SlabDumpChannel
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.sph import make_slab_step_fn, resume
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)

CPU = "cpu"
#: capacity of the scenarios here, whose densest cell holds 27 particles:
#: the reference's tests allot 48 or 64 slots, whose extra slots hold
#: only zeros, and a plain pair pass costs K^2 a cell
CAP = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the suite runs several
    test processes on the same cores, where each op's parallel region
    waits for descheduled threads (these steps are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
KEYS = ("position", "velocity", "density", "pressure")
CHUNKS = ["particles/" + k for k in KEYS]


def _port(sc, grid=None):
    st = sc.state
    return (
        grid_from_reference(sc.grid if grid is None else grid),
        params_from_reference(sc.params),
        state_from_numpy(st.x, st.v, CPU, rho=st.rho),
    )


def _writer(path):
    return ShardedFrameWriter(path, application="test", comm=SingleComm())


def _frames(path):
    """Every frame's chunks and step, read by both packages' pure-Python
    readers (which must agree), and both packages' deep verify."""
    frames = []
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f, \
            tpgsd.pypgsd.PGSDFile(open(path, "rb")) as g:
        assert f.nframes == g.nframes
        for i in range(f.nframes):
            frame = {}
            for name in CHUNKS + ["configuration/step"]:
                if f.chunk_exists(i, name):
                    frame[name] = f.read_chunk(i, name)
                    numpy.testing.assert_array_equal(frame[name],
                                                     g.read_chunk(i, name))
            frames.append(frame)
    for verify in (tpgsd_torch.pypgsd.verify, tpgsd.pypgsd.verify):
        with open(path, "rb") as fh:
            report = verify(fh, deep=True)
        assert report["ok"], report["errors"]
        assert report["frames"] == len(frames)
    return frames


def _roundtrip(tmp_path, db, n_slabs, steps=3, dump_every=2, n_fixed=0,
               grid=None, reference=False, **kw):
    """``steps`` slab steps emitting every ``dump_every``-th through the
    port's channel, against the same step without emission; with
    ``reference`` also the JAX channel on the same input (its jnp slab
    step)."""
    grid_p, params, state0 = _port(db, grid)
    path = str(tmp_path / "slabdump.gsd")
    chan = SlabDumpChannel(_writer(path), n=db.n, n_slabs=n_slabs, keys=KEYS)
    step = make_slab_step_fn(grid_p, params, n_slabs=n_slabs, n_fixed=n_fixed,
                             slab_emit=chan.slab_emit, device=CPU, **kw)
    ref_step = make_slab_step_fn(grid_p, params, n_slabs=n_slabs,
                                 n_fixed=n_fixed, device=CPU, **kw)
    state, sref = state0, state0
    expected = []
    for i in range(steps):
        emitting = i % dump_every == 0
        state, _aux = step(state, chan.dump(i) if emitting else chan.no_dump())
        sref, (rho, p, _o, w) = ref_step(sref)
        assert int(w) == 0
        if emitting:
            expected.append((i, sref, rho, p))
    # the emitting and silent paths stay in lockstep with the plain step
    assert torch.equal(state.x, sref.x) and torch.equal(state.v, sref.v)
    chan.close()
    assert chan.stats.frames == len(expected)
    frames = _frames(path)
    assert len(frames) == len(expected)
    for frame, (step_i, s, rho, p) in zip(frames, expected):
        for name, want in zip(CHUNKS, (s.x, s.v, rho, p)):
            numpy.testing.assert_array_equal(frame[name], want.numpy())
        numpy.testing.assert_array_equal(frame["configuration/step"], [step_i])

    if reference:
        ref_path = str(tmp_path / "ref_slabdump.gsd")
        ref_chan = RefSlabDumpChannel(RefShardedFrameWriter(ref_path),
                                      n=db.n, n_slabs=n_slabs, keys=KEYS)
        rkw = {k: v for k, v in kw.items() if k != "spill"}
        rstep = jax.jit(ref_make_slab_step_fn(
            db.grid if grid is None else grid, db.params, n_slabs=n_slabs,
            n_fixed=n_fixed, slab_emit=ref_chan.slab_emit, use_pallas=False,
            **rkw))
        rstate = db.state
        for i in range(steps):
            dump = ref_chan.dump(i) if i % dump_every == 0 else \
                ref_chan.no_dump()
            rstate, _ = rstep(rstate, dump)
        jax.block_until_ready(rstate.x)
        ref_chan.close()
        ref_frames = _frames(ref_path)
        assert len(ref_frames) == len(frames)
        for got, want in zip(frames, ref_frames):
            x, v, rho = (got["particles/" + k] for k in KEYS[:3])
            numpy.testing.assert_allclose(
                x, want["particles/position"], rtol=1e-5, atol=1e-6)
            numpy.testing.assert_allclose(
                v, want["particles/velocity"], rtol=2e-4, atol=2e-4)
            numpy.testing.assert_allclose(
                rho, want["particles/density"], rtol=5e-4, atol=1e-2)
    return chan


def test_slab_dump_frames_equal_post_step_state(tmp_path):
    """Every streamed frame is bit-identical to the post-step state, and
    within tolerance of the JAX channel's frames."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    assert db.grid.dims[0] % 3 == 0, db.grid.dims
    chan = _roundtrip(tmp_path, db, n_slabs=3, reference=True)
    # every emitting step copies 3 whole windows of ceil(3 n / 3) rows:
    # 8 float32 columns, an int32 id and the two int64 scalars a row
    w = db.n
    assert chan.d2h_bytes == 2 * 3 * (w * (8 * 4 + 4) + 16)
    # the scatters and the frames' hand-off to the writer are timed apart
    assert chan.emit_host_seconds > 0 and chan.handoff_seconds > 0


def test_slab_dump_with_fixed_boundary(tmp_path):
    """n_fixed boundary rows keep their positions and zero velocity in
    the streamed frames (the pid mask of the windows, the index mask of
    the epilogue)."""
    db = ref_hydrostatic_tank(n_side=8, capacity=CAP)
    S = 2 if db.grid.dims[0] % 2 == 0 else 1
    _roundtrip(tmp_path, db, n_slabs=S, n_fixed=db.n_fixed)


def test_slab_dump_spill(tmp_path):
    """The emission composes with the two-tier spill slab (the plain spill
    ops): windows gather from the concatenated-tier bundle.  K = 24 puts
    particles in the spill tier."""
    db = ref_dam_break(n_side=10, capacity="auto", capacity_headroom=1.15)
    grid = db.grid._replace(capacity=24)
    _roundtrip(tmp_path, db, n_slabs=3, steps=2, dump_every=1, grid=grid,
               spill=True)


def test_slab_dump_continuity(tmp_path):
    """Continuity mode: the emitted density is the updated carried density
    (the window's carried density + dt * drho), bit-identical to the
    post-step state and within tolerance of the JAX channel's."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    db = db._replace(state=ref_init_density(db.state, db.grid, db.params))
    _roundtrip(tmp_path, db, n_slabs=3, density_mode="continuity",
               reference=True)


def test_slab_dump_resume_roundtrip(tmp_path):
    """A pipelined-dump file resumes like a plain-dump file."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, state = _port(db)
    path = str(tmp_path / "res.gsd")
    chan = SlabDumpChannel(_writer(path), n=db.n, n_slabs=3,
                           keys=("position", "velocity", "density"))
    step = make_slab_step_fn(grid, params, n_slabs=3,
                             slab_emit=chan.slab_emit, device=CPU)
    for i in range(2):
        state, _aux = step(state, chan.dump(i))
    chan.close()
    state2, last_step, writer, _extra = resume(path, comm=SingleComm(),
                                               device=CPU)
    try:
        assert last_step == 1
        assert torch.equal(state2.x, state.x)
        assert torch.equal(state2.v, state.v)
    finally:
        writer.close()


def test_slab_dump_bad_key_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown dump keys"):
        SlabDumpChannel(_writer(str(tmp_path / "x.gsd")), n=10, n_slabs=2,
                        keys=("position", "entropy"))


def test_slab_dump_window_overflow_gap_warns(tmp_path):
    """Rows past a slab's emission window appear in no emission (the step
    counts them as aux[3] window overflow); the channel surfaces the gap
    instead of silently writing zero rows."""
    db = ref_dam_break(n_side=9, capacity=CAP)
    assert db.grid.dims[0] % 2 == 0, db.grid.dims
    grid, params, state = _port(db)
    path = str(tmp_path / "gap.gsd")
    chan = SlabDumpChannel(_writer(path), n=db.n, n_slabs=2,
                           keys=("position",))
    step = make_slab_step_fn(grid, params, n_slabs=2, window=db.n // 3,
                             slab_emit=chan.slab_emit, device=CPU)
    with pytest.warns(RuntimeWarning, match="window overflow"):
        state, (_rho, _p, _co, wo) = step(state, chan.dump(0))
        chan.flush()
    assert int(wo) > 0  # the step counted the same overflow
    assert chan.gap_rows == int(wo)
    chan.close()
    # the frame is still written (everything but the gap is valid), and
    # the rows of the gap are zero
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 1
        x = f.read_chunk(0, "particles/position")
    written = (x == state.x.numpy()).all(axis=1)
    assert int((~written).sum()) == int(wo)
    assert not x[~written].any()


def test_slab_dump_channel_mismatch_errors():
    """Host-side validation of the channel/step contract."""
    d = tempfile.mkdtemp()
    chan = SlabDumpChannel(_writer(os.path.join(d, "m.gsd")), n=100,
                           n_slabs=2, keys=("position",))
    pids = numpy.arange(4, dtype=numpy.int32)
    payload = numpy.zeros((4, 8), numpy.float32)
    with pytest.raises(ValueError, match="n_slabs"):
        chan.slab_emit(0, 5, 0, 4, pids, payload)  # slab index >= 2
    with pytest.raises(ValueError, match="particle id"):
        chan.slab_emit(0, 0, 0, 4, pids + 200, payload)  # pid >= n
    # a channel expecting more slabs than the step emits: the frame never
    # completes -> warned and dropped at close, not silently half-written
    with pytest.warns(RuntimeWarning, match="incomplete frame"):
        chan.close()


def test_slab_step_missing_dump_arg_raises():
    db = ref_dam_break(n_side=9, capacity=CAP)
    grid, params, state = _port(db)
    step = make_slab_step_fn(grid, params, n_slabs=2,
                             slab_emit=lambda *a: None, device=CPU)
    with pytest.raises(TypeError, match="chan.dump"):
        step(state)


def test_emission_failure_surfaces_at_the_next_call(tmp_path):
    """A failure on the emission thread is raised at the next submit,
    ``dump``, ``flush`` or ``close``, never swallowed; the thread frees
    every ring buffer it took, so nothing waits on it."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, state = _port(db)
    bad = make_slab_step_fn(grid, params, n_slabs=3, device=CPU,
                            slab_emit=lambda *a: 1 / 0)
    path = str(tmp_path / "f.gsd")
    chan = SlabDumpChannel(_writer(path), n=db.n, n_slabs=3,
                           keys=("position",))
    good = make_slab_step_fn(grid, params, n_slabs=3,
                             slab_emit=chan.slab_emit, device=CPU)
    good(state, chan.dump(0))
    # a ring of RING = 2 buffers: the third slab's submit waits until the
    # thread has freed the first slab's buffer after its failure, and
    # raises it (or an earlier submit does)
    with pytest.raises(RuntimeError, match="slab emission failed"):
        bad(state, chan.dump(1))
    bad(state, chan.no_dump())  # a silent step emits nothing
    good(state, chan.dump(2))
    chan.close()
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert [int(f.read_chunk(i, "configuration/step")[0])
                for i in range(f.nframes)] == [0, 2]

    # both slabs of a 2-slab step queue behind a callback that waits for
    # the gate, so the failure comes after the step and waits for a call
    db = ref_dam_break(n_side=9, capacity=CAP)
    grid, params, state = _port(db)
    gate = threading.Event()

    def gated(*args):
        gate.wait(60)
        raise ZeroDivisionError("gated")

    queued = make_slab_step_fn(grid, params, n_slabs=2, device=CPU,
                               slab_emit=gated)
    chan = SlabDumpChannel(_writer(str(tmp_path / "g.gsd")), n=db.n,
                           n_slabs=2, keys=("position",))
    for call in ("flush", "dump", "close"):
        gate.clear()
        queued(state, chan.dump(0))
        gate.set()
        chan._pipe._work.join()  # the thread has met the failure
        with pytest.raises(RuntimeError, match="slab emission failed"):
            if call == "dump":
                chan.dump(1)
            else:
                getattr(chan, call)()


def test_emission_pipe_keeps_order_under_thread_switching():
    """Stress of the ring: 300 windows through the pipe with the
    interpreter switching threads every microsecond; every window reaches
    the callback once, in order, with its own contents (a buffer reused
    before its callback ran would deliver another window's values)."""
    import sys

    from tpgsd_torch.io_runtime.slab_dump import RING, _EmitPipe

    got = []

    def record(step, slab, p0, rows, pids, payload):
        got.append((step, slab, p0, rows, int(pids[0]),
                    float(payload[0, 0]), payload.shape))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pipe = _EmitPipe()
    try:
        for i in range(300):
            w = 5 + i % 7
            pipe.submit(record, i // 3, i % 3, torch.tensor(i),
                        torch.tensor(2 * i),
                        torch.full((w,), i, dtype=torch.int32),
                        torch.full((w, 8), float(i)))
        pipe.close()
    finally:
        sys.setswitchinterval(old)
    assert not pipe._thread.is_alive()
    assert RING < 300
    assert got == [(i // 3, i % 3, i, 2 * i, i, float(i), (5 + i % 7, 8))
                   for i in range(300)]
