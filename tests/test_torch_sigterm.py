"""SIGTERM and the port's numpy-only file stack.

* ``import tpgsd_torch`` turns SIGTERM into ``SystemExit(1)``, as
  ``import tpgsd`` does, so a process stopped by a batch scheduler
  unwinds its ``with`` blocks: an ``AsyncDumpRunner`` drains the frames
  already submitted and a ``hoomd`` trajectory flushes.  One script, run
  in a subprocess for each package, signals itself after the 3rd of 4
  frames; both processes exit with 1 and both files hold the same 3
  frames.
* ``tpgsd_torch.format`` / ``io`` / ``fl`` / ``pypgsd`` / ``hoomd`` /
  ``vtu`` and the command line import and run with ``torch`` blocked,
  while with torch loaded a traced write is still a
  ``torch.profiler.record_function`` range.
"""

import os
import pathlib
import subprocess
import sys

import numpy
import pytest
import torch

import tpgsd.fl
import tpgsd_torch.fl
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.utils import get_tracer

REPO = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES, SIGNAL_AFTER = 4, 3

#: argv: package, "dump" | "hoomd", path.  Each frame's positions are
#: ``k + arange``; the writer sleeps in every frame, so frames are still
#: queued when the signal arrives.
_SCRIPT = r"""
import os, signal, sys, time
import numpy

pkg, mode, path = sys.argv[1:4]
n_frames, signal_after = int(sys.argv[4]), int(sys.argv[5])


def positions(k):
    return numpy.arange(300, dtype=numpy.float32).reshape(100, 3) + k


if mode == "dump":
    if pkg == "tpgsd":
        from tpgsd.io_runtime import AsyncDumpRunner
        from tpgsd.parallel import ShardedFrameWriter, SingleComm
    else:
        from tpgsd_torch.io_runtime import AsyncDumpRunner
        from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

    class SlowWriter(ShardedFrameWriter):
        def write_frame(self, chunks, step=None):
            time.sleep(0.1)
            return super().write_frame(chunks, step=step)

    writer = SlowWriter(path, comm=SingleComm())
    with AsyncDumpRunner(writer, depth=4) as dump:
        for k in range(n_frames):
            dump.submit({"particles/position": positions(k)}, step=k)
            if k + 1 == signal_after:
                os.kill(os.getpid(), signal.SIGTERM)
else:
    hoomd = __import__(pkg + ".hoomd", fromlist=["hoomd"])
    with hoomd.open(path, mode="w") as traj:
        for k in range(n_frames):
            frame = hoomd.Frame()
            frame.configuration.step = k
            frame.particles.N = 100
            frame.particles.position = positions(k)
            traj.append(frame)
            if k + 1 == signal_after:
                os.kill(os.getpid(), signal.SIGTERM)
print("NOT_STOPPED")
"""


def _frames(path):
    """Every frame's chunks, read through the reference's file layer."""
    with tpgsd.fl.open(path, "r") as f:
        return [
            {name: f.read_chunk(i, name)
             for name in f.find_matching_chunk_names("")
             if f.chunk_exists(i, name)}
            for i in range(f.nframes)
        ]


@pytest.mark.parametrize("mode", ["dump", "hoomd"])
def test_sigterm_drains_submitted_frames_like_the_reference(tmp_path, mode):
    files = {}
    for pkg in ("tpgsd", "tpgsd_torch"):
        path = str(tmp_path / ("%s_%s.gsd" % (pkg, mode)))
        proc = subprocess.run(
            [sys.executable, "-c", _SCRIPT, pkg, mode, path, str(N_FRAMES),
             str(SIGNAL_AFTER)],
            cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1, (pkg, proc.returncode, proc.stderr[-2000:])
        assert "NOT_STOPPED" not in proc.stdout
        files[pkg] = _frames(path)
    ref, port = files["tpgsd"], files["tpgsd_torch"]
    assert len(ref) == len(port) == SIGNAL_AFTER
    for k, (want, got) in enumerate(zip(ref, port)):
        assert got.keys() == want.keys()
        for name in want:
            numpy.testing.assert_array_equal(got[name], want[name])
            assert got[name].dtype == want[name].dtype
        numpy.testing.assert_array_equal(
            got["particles/position"],
            numpy.arange(300, dtype=numpy.float32).reshape(100, 3) + k)
        if mode == "dump":  # hoomd leaves out a step equal to frame 0's
            assert int(got["configuration/step"][0]) == k


_THREAD_IMPORT = r"""
import signal, threading
errors = []

def target():
    try:
        import tpgsd_torch
    except BaseException as e:
        errors.append(repr(e))

t = threading.Thread(target=target)
t.start()
t.join(60)
assert not t.is_alive() and errors == [], errors
# off the main thread the handler is not installed
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
print("THREAD_IMPORT_OK")
"""


def test_import_off_the_main_thread_does_not_raise():
    proc = subprocess.run(
        [sys.executable, "-c", _THREAD_IMPORT], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "THREAD_IMPORT_OK" in proc.stdout


_NUMPY_ONLY = r"""
import sys
for blocked in ("torch", "jax", "tpgsd"):
    sys.modules[blocked] = None
import numpy
import tpgsd_torch.format, tpgsd_torch.io, tpgsd_torch.fl
import tpgsd_torch.pypgsd, tpgsd_torch.hoomd, tpgsd_torch.vtu
import tpgsd_torch.version, tpgsd_torch.__main__
from tpgsd_torch.utils import TraceRecorder, get_tracer

path = sys.argv[1]
tracer = get_tracer().enable(keep_events=True)
with tpgsd_torch.hoomd.open(path, mode="w") as traj:
    frame = tpgsd_torch.hoomd.Frame()
    frame.particles.N = 5
    frame.particles.position = numpy.ones((5, 3), numpy.float32)
    traj.append(frame)
with tpgsd_torch.fl.open(path, "r") as f:
    got = f.read_chunk(0, "particles/position")
assert got.shape == (5, 3) and (got == 1).all()
assert tpgsd_torch.pypgsd.verify(path)["ok"]
assert any(e["kind"].startswith("write") for e in tracer.events)
assert {e["process"] for e in tracer.events} == {0}
rec = TraceRecorder().enable(keep_events=True)
with rec.span("write_frame", frame=0):
    pass
with rec.range("step"):
    pass
assert [e["kind"] for e in rec.events] == ["write_frame"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "tpgsd")
                and sys.modules[m] is not None)
assert loaded == [], loaded
print("NUMPY_ONLY_OK")
"""


def test_file_stack_and_cli_run_with_torch_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NUMPY_ONLY, str(tmp_path / "np.gsd")],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NUMPY_ONLY_OK" in proc.stdout


def test_traced_write_is_a_record_function_range(tmp_path):
    tracer = get_tracer()
    tracer.enable(keep_events=True)
    try:
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]
        ) as prof:
            with ShardedFrameWriter(str(tmp_path / "traced.gsd"),
                                    comm=SingleComm()) as writer:
                writer.write_frame({"particles/position": torch.ones(8, 3)},
                                   step=0)
        kinds = {e["kind"] for e in tracer.events}
    finally:
        tracer.disable()
        tracer.events.clear()
    ranges = {e.key for e in prof.key_averages()
              if e.key.startswith("tpgsd:")}
    assert ranges and ranges <= {"tpgsd:" + k for k in kinds}
    assert ranges & {"tpgsd:write_chunk", "tpgsd:write_batch"}
    with tpgsd_torch.fl.open(str(tmp_path / "traced.gsd"), "r") as f:
        assert f.nframes == 1

