"""The port's compose-on-commit writer (``tpgsd_torch.parallel.
compose_io``): the twin of tests/test_compose_io.py.

Spill files are append-only per process; the composed output must be an
ordinary GSD v2 file, byte-equal to the JAX package's composed file and
to the port's direct ``ShardedFrameWriter`` file from the same frames.
The last case spills from two real processes over ``TorchProcessComm``
(Gloo) and composes on the controller.
"""

import numpy
import numpy.testing
import pytest

import tpgsd.parallel.compose_io as ref_compose_io
import tpgsd_torch.pypgsd
from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.parallel import (
    ComposedFrameWriter,
    ShardedFrameWriter,
    SingleComm,
    compose,
    launch,
    worker,
)
from tpgsd_torch.parallel.compose_io import _MAGIC, _REC

#: seconds the two-process case may take, spawn included
SPAWN_TIMEOUT_S = 120


def _frames(n_frames=3, n=24, seed=0):
    rng = numpy.random.RandomState(seed)
    return [{"particles/position": rng.rand(n, 3).astype(numpy.float32),
             "particles/density": rng.rand(n).astype(numpy.float32)}
            for _ in range(n_frames)]


def _write(cls, path, frames, **kw):
    with cls(str(path), application="t", **kw) as w:
        for i, fr in enumerate(frames):
            w.write_frame(fr, step=i)


def test_composed_matches_direct_and_reference(tmp_path):
    """One process: the composed file is byte-equal to the direct
    writer's and to the JAX package's composed file, and the spills are
    gone."""
    frames = _frames()
    _write(ShardedFrameWriter, tmp_path / "direct.gsd", frames,
           comm=SingleComm())
    _write(ComposedFrameWriter, tmp_path / "composed.gsd", frames,
           comm=SingleComm())
    _write(ref_compose_io.ComposedFrameWriter, tmp_path / "reference.gsd",
           frames)
    assert not list(tmp_path.glob("*.spill*"))
    composed = (tmp_path / "composed.gsd").read_bytes()
    assert composed == (tmp_path / "direct.gsd").read_bytes()
    assert composed == (tmp_path / "reference.gsd").read_bytes()
    with tpgsd_torch.pypgsd.PGSDFile(open(tmp_path / "composed.gsd", "rb")) as f:
        assert f.nframes == 3
        numpy.testing.assert_array_equal(f.read_chunk(2, "particles/density"),
                                         frames[2]["particles/density"])
        assert not f._find_chunk(1, "particles/N")


def _crashed(path, frames):
    """A writer that spilled ``frames`` and died without its end marker;
    returns its spill path."""
    w = ComposedFrameWriter(str(path), application="t", comm=SingleComm(),
                            keep_spills=True)
    for i, fr in enumerate(frames):
        w.write_frame(fr, step=i)
    return w


def test_compose_truncates_torn_tail(tmp_path):
    """Without the end marker the last started frame is distrusted, and a
    torn record is ignored."""
    path = str(tmp_path / "torn.gsd")
    frames = _frames(n_frames=3, n=8)
    w = _crashed(path, frames)
    w.flush()
    spill = w._spill_paths[0]
    w._fh.close()
    w._closed = True
    with open(spill, "ab") as fh:
        fh.write(_REC.pack(_MAGIC, 4, 3, 0, 1000, 3, 6, 0, 0))
        fh.write(b"nametruncated")
    assert compose(path, [spill], application="t") == 2
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 2
        numpy.testing.assert_array_equal(f.read_chunk(1, "particles/position"),
                                         frames[1]["particles/position"])


def test_compose_drops_midframe_crash(tmp_path):
    """A frame spilled only in part is dropped whole."""
    path = str(tmp_path / "midframe.gsd")
    frames = _frames(n_frames=1, n=8)
    w = _crashed(path, frames)
    w._append_record("particles/position", 1, 0,
                     frames[0]["particles/position"])
    w.flush()
    spill = w._spill_paths[0]
    w._fh.close()
    w._closed = True
    assert compose(path, [spill], application="t") == 1
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 1


def test_clean_close_keeps_last_frame(tmp_path):
    """With the end marker every frame composes, and the file passes the
    deep fsck walk."""
    path = str(tmp_path / "clean.gsd")
    _write(ComposedFrameWriter, path, _frames(n_frames=2, n=8),
           comm=SingleComm())
    report = tpgsd_torch.pypgsd.verify(path, deep=True)
    assert report["ok"], report["errors"]
    assert report["frames"] == 2


def test_composed_through_async_dump_runner(tmp_path):
    """Async double-buffered dumps into the composing writer."""
    path = str(tmp_path / "async.gsd")
    frames = _frames(n_frames=4, n=16)
    with AsyncDumpRunner(ComposedFrameWriter(path, application="t",
                                             comm=SingleComm()),
                         depth=2) as dump:
        for i, fr in enumerate(frames):
            dump.submit(fr, step=i)
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 4
        numpy.testing.assert_array_equal(f.read_chunk(3, "particles/position"),
                                         frames[3]["particles/position"])
    assert tpgsd_torch.pypgsd.verify(path)["ok"]


def test_composed_rejects_3d_arrays(tmp_path):
    w = ComposedFrameWriter(
        str(tmp_path / "bad3d.gsd"), application="t", comm=SingleComm(),
        static={"bad/threed": numpy.ones((2, 3, 4), numpy.float32)})
    with pytest.raises(ValueError, match="1 or 2 dimensional"):
        w.write_frame({"particles/position": numpy.zeros((4, 3),
                                                         numpy.float32)})
    w._fh.close()
    w._closed = True


def test_composed_needs_a_communicator(tmp_path):
    """The port has no default communicator: ``comm`` must be given."""
    with pytest.raises(ValueError, match="comm="):
        ComposedFrameWriter(str(tmp_path / "x.gsd"), comm=None)
    with pytest.raises(TypeError):
        ComposedFrameWriter(str(tmp_path / "x.gsd"))
    assert not list(tmp_path.iterdir())


def test_two_process_compose(tmp_path):
    """Two real processes (Gloo) spill their own rows privately; the
    controller composes one file, byte-equal to the one process's."""
    path = str(tmp_path / "mp_composed.gsd")
    rows = 3
    worker.write_case(tmp_path, [{"kind": "composed", "path": path,
                                  "rows": rows}])
    launch.spawn(tmp_path, 2, SPAWN_TIMEOUT_S).check()
    assert not list(tmp_path.glob("*.spill*"))
    one = str(tmp_path / "one.gsd")
    whole = [numpy.concatenate(parts) for parts in zip(
        *(worker.log_frames(r, 2, rows, 3) for r in range(2)))]
    with ComposedFrameWriter(one, schema="none", schema_version=(1, 0),
                             comm=SingleComm()) as w:
        for i, d in enumerate(whole):
            w.write_frame({"log/d": d}, step=i)
    assert open(path, "rb").read() == open(one, "rb").read()
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 3
        numpy.testing.assert_array_equal(f.read_chunk(2, "log/d"), whole[2])
