"""The port's file layer over several ranks without processes: the twin
of tests/test_multirank.py.

``ThreadComm`` (from tests/test_multirank.py) runs N threads as N ranks,
each driving its own ``PGSDFile`` handle on the same file through the
whole collective protocol.  Every case runs the same work once on the
JAX package's ``tpgsd.fl`` and once on the port's ``tpgsd_torch.fl``,
and the two files must be byte-equal; then the case's own checks read the
port's file back.  The last cases hold the port's writers
(``ShardedFrameWriter``, ``ComposedFrameWriter``) with per-rank
``ProcessShards`` to the single-process file, build a mesh over the
ranks, check the shard value's layout on its own, and resume a
decomposed state onto a mesh over the ranks.
"""

import sys
from io import StringIO

import numpy
import numpy.testing
import pytest
import torch

import tpgsd.fl
import tpgsd_torch.fl
import tpgsd_torch.pypgsd
from tests.test_compat import _make_v1_file
from tests.test_multirank import ThreadComm, run_ranks
from tpgsd_torch.parallel import (
    ComposedFrameWriter,
    ProcessShards,
    ShardedFrameWriter,
    SingleComm,
    array_shards,
    make_mesh,
    make_mesh2d,
    read_sharded_chunk,
)
from tpgsd_torch.sph import frame_shards
from tpgsd_torch.sph.distributed import concat_shards

FLS = {"reference": tpgsd.fl, "port": tpgsd_torch.fl}


def _twin(tmp_path, size, work, prepare=None):
    """Run ``work(fl, fname)(rank, comm)`` on ``size`` thread ranks with
    each package's ``fl`` (``prepare(path)`` makes the file first, when
    given); returns the port's file name after checking that both files
    are byte-equal."""
    names = {}
    for which, fl in FLS.items():
        fname = tmp_path / ("%s.gsd" % which)
        if prepare is not None:
            prepare(fname)
        run_ranks(size, work(fl, str(fname)))
        names[which] = fname
    assert names["port"].read_bytes() == names["reference"].read_bytes()
    return str(names["port"])


def _openers(fname):
    return (lambda: tpgsd_torch.fl.open(fname, "r"),
            lambda: tpgsd_torch.pypgsd.PGSDFile(open(fname, "rb")))


def test_striped_collective_write(tmp_path):
    """3 ranks write uneven row partitions of shared chunks."""
    counts = numpy.array([5, 3, 4], dtype=numpy.uint64)
    n = int(counts.sum())
    base = numpy.arange(n * 2, dtype=numpy.float64).reshape(n, 2)

    def work(fl, fname):
        def run(rank, comm):
            lo = int(counts[:rank].sum())
            hi = lo + int(counts[rank])
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm)
            for frame in range(3):
                f.write_chunk("particles/data", base[lo:hi] + frame,
                              offset=counts, rank=rank, write_all=True)
                f.end_frame()
            f.close()
        return run

    fname = _twin(tmp_path, 3, work)
    for opener in _openers(fname):
        with opener() as f:
            assert f.nframes == 3
            for frame in range(3):
                numpy.testing.assert_array_equal(
                    f.read_chunk(frame, "particles/data"), base + frame)


def test_rank0_scalars_plus_striped(tmp_path):
    """Controller-only buffered scalars mix with striped chunks."""
    counts = numpy.array([4, 4], dtype=numpy.uint64)
    pos = numpy.random.RandomState(0).rand(8, 3).astype(numpy.float32)

    def work(fl, fname):
        def run(rank, comm):
            f = fl.PGSDFile(fname, "w", application="mr", schema="hoomd",
                            schema_version=(1, 4), comm=comm)
            for frame in range(2):
                f.write_chunk("configuration/step",
                              numpy.array([frame], numpy.uint64),
                              write_all=False)
                lo = rank * 4
                f.write_chunk("particles/position",
                              pos[lo:lo + 4] * (frame + 1), offset=counts,
                              rank=rank, write_all=True)
                f.end_frame()
            f.close()
        return run

    fname = _twin(tmp_path, 2, work)
    with tpgsd_torch.fl.open(fname, "r") as f:
        assert f.nframes == 2
        assert f.read_chunk(1, "configuration/step")[0] == 1
        numpy.testing.assert_allclose(f.read_chunk(1, "particles/position"),
                                      pos * 2)


def test_single_writer_direct_write_all_false(tmp_path):
    """A write_all=False chunk past the buffer cap is written by the
    controller alone; every rank writes its own stripe."""
    big = numpy.arange(4096, dtype=numpy.float64)
    data_writes = {which: [0, 0, 0] for which in FLS}

    def work(fl, fname):
        which = "port" if fl is tpgsd_torch.fl else "reference"

        def run(rank, comm):
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm)
            f.maximum_write_buffer_size = 1024
            orig = f._fh.pwrite_many

            def counting(writes):
                data_writes[which][rank] += len(writes)
                return orig(writes)

            f._fh.pwrite_many = counting
            f.write_chunk("big", big, write_all=False)
            f.write_chunk("striped", numpy.full(4, rank, numpy.int32),
                          offset=numpy.array([4, 4, 4], numpy.uint64),
                          rank=rank)
            f.end_frame()
            f.close()
        return run

    fname = _twin(tmp_path, 3, work)
    got = data_writes["port"]
    assert got[0] >= 2 and got[1] == 1 and got[2] == 1
    assert got == data_writes["reference"]
    with tpgsd_torch.fl.open(fname, "r") as f:
        numpy.testing.assert_array_equal(f.read_chunk(0, "big"), big)
        numpy.testing.assert_array_equal(
            f.read_chunk(0, "striped"),
            numpy.repeat(numpy.arange(3, dtype=numpy.int32), 4))


def test_all_ranks_read_after_write(tmp_path):
    """Every rank resolves and reads chunks committed in the session."""
    counts = numpy.array([3, 3], dtype=numpy.uint64)
    data = numpy.arange(6, dtype=numpy.int32)

    def work(fl, fname):
        def run(rank, comm):
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm)
            lo = rank * 3
            f.write_chunk("d", data[lo:lo + 3], offset=counts, rank=rank)
            f.end_frame()
            assert f.chunk_exists(0, "d")
            numpy.testing.assert_array_equal(f.read_chunk(0, "d"), data)
            stripe = f.read_chunk(0, "d", N=3, M=1, offset=lo, r_all=True)
            numpy.testing.assert_array_equal(stripe, data[lo:lo + 3])
            f.close()
        return run

    _twin(tmp_path, 2, work)


def _diverging(strict):
    def work(fl, fname):
        def run(rank, comm):
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm, strict=strict)
            if rank == 1:
                f._cur_frame += 1  # a missed frame
            f.write_chunk("d", numpy.arange(2, dtype=numpy.int32),
                          offset=numpy.array([1, 1], numpy.uint64),
                          rank=rank)
            f.end_frame()
            f.close()
        return run
    return work


def test_consistency_check_reports_divergence(tmp_path):
    """Ranks completing different frame counts are reported.  (No byte
    comparison here: what a diverged pair of ranks writes depends on
    which thread reaches the file first.)"""
    fname = str(tmp_path / "diverge.gsd")
    captured, old = StringIO(), sys.stderr
    sys.stderr = captured
    try:
        run_ranks(2, _diverging(False)(tpgsd_torch.fl, fname))
    finally:
        sys.stderr = old
    assert "frame counters diverge" in captured.getvalue()


def test_strict_mode_raises_on_divergence(tmp_path):
    """With strict=True a diverged port writer raises."""
    fname = str(tmp_path / "strict.gsd")
    with pytest.raises(AssertionError, match="consistency error"):
        run_ranks(2, _diverging(True)(tpgsd_torch.fl, fname))


def test_append_reopen_multirank(tmp_path):
    """Append mode across a reopen continues the frame counter on every
    rank."""
    counts = numpy.array([2, 2], dtype=numpy.uint64)

    def work(fl, fname):
        def session(mode):
            def run(rank, comm):
                if mode == "w":
                    f = fl.PGSDFile(fname, "w", application="mr",
                                    schema="none", schema_version=(1, 0),
                                    comm=comm)
                else:
                    f = fl.PGSDFile(fname, "a", comm=comm)
                f.write_chunk("d", numpy.full(2, f.nframes, numpy.int32),
                              offset=counts, rank=rank)
                f.end_frame()
                f.close()
            return run

        def both(rank, comm):
            session("w")(rank, comm)
            comm.barrier()
            session("a")(rank, comm)
        return both

    fname = _twin(tmp_path, 2, work)
    with tpgsd_torch.fl.open(fname, "r") as f:
        assert f.nframes == 2
        numpy.testing.assert_array_equal(f.read_chunk(1, "d"),
                                         numpy.full(4, 1, numpy.int32))


def test_flush_metadata_is_batched(tmp_path):
    """A flush costs at most two object broadcasts on the port's file
    layer, and the file equals the reference's."""
    counts = numpy.array([2, 2], dtype=numpy.uint64)
    per_flush = {}

    class CountingComm(ThreadComm):
        calls = [0, 0]

        def bcast(self, value, root=0):
            self.calls[self.rank] += 1
            return super().bcast(value, root)

    def work(fl, fname):
        def run(rank, comm):
            comm = CountingComm(rank, comm._s)
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm)
            f.write_chunk("d", numpy.arange(2, dtype=numpy.int32),
                          offset=counts, rank=rank)
            before = comm.calls[rank]
            f.end_frame()
            per_flush[(fl.__name__, rank)] = comm.calls[rank] - before
            f.close()
        return run

    _twin(tmp_path, 2, work)
    assert all(0 < n <= 2 for n in per_flush.values()), per_flush


def test_buffer_cap_overflow_multirank(tmp_path):
    """Buffered chunks crossing the write-buffer cap mid-frame flush
    collectively on every rank."""
    payload = numpy.arange(64, dtype=numpy.float64)

    def work(fl, fname):
        def run(rank, comm):
            f = fl.PGSDFile(fname, "w", application="mr", schema="none",
                            schema_version=(1, 0), comm=comm)
            f.maximum_write_buffer_size = 4096
            for frame in range(2):
                for c in range(30):
                    f.write_chunk("log/q%02d" % c, payload + frame * 30 + c,
                                  write_all=False)
                f.end_frame()
            f.close()
        return run

    fname = _twin(tmp_path, 2, work)
    for opener in _openers(fname):
        with opener() as f:
            assert f.nframes == 2
            for frame in range(2):
                for c in range(30):
                    numpy.testing.assert_array_equal(
                        f.read_chunk(frame, "log/q%02d" % c),
                        payload + frame * 30 + c)


def test_upgrade_multirank(tmp_path):
    """Collective v1 -> v2 upgrade: only the controller mutates the
    file, and every rank keeps appending."""
    rng = numpy.random.RandomState(3)
    frames = [[("d", rng.rand(6).astype(numpy.float32))] for _ in range(2)]
    writes = {}

    def work(fl, fname):
        def run(rank, comm):
            f = fl.PGSDFile(fname, "r+", comm=comm)
            fh, count = f._fh, [0]

            class Counting:
                def __getattr__(self, name):
                    attr = getattr(fh, name)
                    if name in ("pwrite", "pwrite_many", "truncate", "fsync"):
                        def counted(*a, **kw):
                            count[0] += 1
                            return attr(*a, **kw)
                        return counted
                    return attr

            f._fh = Counting()
            assert f.pgsd_version == (1, 0)
            f.upgrade()
            assert f.pgsd_version == (2, 0)
            writes[(fl.__name__, rank)] = count[0]
            lo = 3 * rank
            data = numpy.arange(6, dtype=numpy.float32)
            f.write_chunk("d", data[lo:lo + 3],
                          offset=numpy.array([3, 3], numpy.uint64), rank=rank)
            f.end_frame()
            f.close()
        return run

    fname = _twin(tmp_path, 2, work,
                  prepare=lambda p: _make_v1_file(p, frames, nframes=2))
    assert writes[("tpgsd_torch.fl", 1)] == 0
    with tpgsd_torch.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.gsd_version == (2, 0) and f.nframes == 3
        for i, chunks in enumerate(frames):
            numpy.testing.assert_array_equal(f.read_chunk(i, "d"),
                                             chunks[0][1])


# --------------------------------------------------------------------------
# the port's writers with per-rank shards
# --------------------------------------------------------------------------


def _rank_frames(n_frames=2):
    rng = numpy.random.RandomState(11)
    return [{"particles/position": rng.rand(12, 3).astype(numpy.float32),
             "log/pid": numpy.arange(12, dtype=numpy.int32) - 2}
            for _ in range(n_frames)]


#: rows of each of 3 ranks: uneven, and rank 1 holds two shards
RANK_ROWS = {0: [(0, 5)], 1: [(5, 7), (7, 9)], 2: [(9, 12)]}


def _rank_shards(frame, rank):
    return {name: ProcessShards(
        starts=tuple(lo for lo, _hi in RANK_ROWS[rank]),
        tensors=tuple(torch.from_numpy(a[lo:hi]) for lo, hi in RANK_ROWS[rank]),
        shape=a.shape) for name, a in frame.items()}


@pytest.mark.parametrize("writer", [ShardedFrameWriter, ComposedFrameWriter],
                         ids=["sharded", "composed"])
def test_writers_with_rank_shards_match_one_process(tmp_path, writer):
    """Three thread ranks each hand the writer its own shards of every
    chunk (``ProcessShards``); the file is byte-equal to the one the same
    writer makes from the whole frames in one process."""
    frames = _rank_frames()
    one = str(tmp_path / "one.gsd")
    with writer(one, application="t", comm=SingleComm()) as w:
        for i, fr in enumerate(frames):
            w.write_frame(fr, step=i)
    ranks = str(tmp_path / "ranks.gsd")

    def run(rank, comm):
        w = writer(ranks, application="t", comm=comm)
        for i, fr in enumerate(frames):
            w.write_frame(_rank_shards(fr, rank), step=i)
        w.close()

    run_ranks(3, run)
    assert open(ranks, "rb").read() == open(one, "rb").read()
    with tpgsd_torch.pypgsd.PGSDFile(open(ranks, "rb")) as f:
        assert f.read_chunk(0, "particles/N")[0] == 12


def test_mesh_over_ranks():
    """With a communicator each rank names its own devices; the mesh is
    their allgather in rank order, and each rank drives its own shards."""
    meshes = {}

    def run(rank, comm):
        meshes[rank] = (make_mesh(devices=["cpu"] * (1 + rank), comm=comm),
                        make_mesh2d(shape=(2, 2), devices=["cpu"] * 2,
                                    comm=comm))

    run_ranks(2, run)
    for rank, (slab, block) in meshes.items():
        assert slab.size == 3 and slab.owners == (0, 1, 1)
        assert slab.local == ((0,) if rank == 0 else (1, 2))
        assert block.shape == (2, 2) and block.owners == (0, 0, 1, 1)
        assert block.local == ((0, 1) if rank == 0 else (2, 3))
        assert block.rank == rank



def test_array_shards_sorts_and_drops_repeated_rows():
    """A process's shards reach the file sorted by row, a row range held
    twice (a replica) once."""
    a = numpy.arange(12, dtype=numpy.float32).reshape(6, 2)
    value = ProcessShards(starts=(4, 0, 4), tensors=(
        torch.from_numpy(a[4:]), torch.from_numpy(a[:2]),
        torch.from_numpy(a[4:].copy())), shape=(9, 2))
    shards, shape = array_shards(value)
    assert shape == (9, 2)
    assert [s for s, _ in shards] == [0, 4]
    numpy.testing.assert_array_equal(shards[1][1], a[4:])


def test_read_sharded_chunk_into_a_layout(tmp_path):
    """``read_sharded_chunk(like=...)`` reads each shard's rows into the
    same layout, rows past the chunk's end zero."""
    path = str(tmp_path / "layout.gsd")
    data = numpy.arange(14, dtype=numpy.int32).reshape(7, 2)
    with ShardedFrameWriter(path, application="t", comm=SingleComm()) as w:
        w.write_frame({"log/d": data})
    like = ProcessShards(starts=(4, 0), tensors=(
        torch.zeros((4, 2), dtype=torch.int32),
        torch.zeros((2, 2), dtype=torch.int32)), shape=(8, 2))
    with tpgsd_torch.fl.open(path, "r") as f:
        back = read_sharded_chunk(f, 0, "log/d", like=like)
    assert back.starts == (4, 0) and back.shape == (7, 2)
    numpy.testing.assert_array_equal(back.tensors[0][:3].numpy(), data[4:])
    assert not back.tensors[0][3].any()
    numpy.testing.assert_array_equal(back.tensors[1].numpy(), data[:2])


def test_frame_shards_write_as_concat_shards(tmp_path):
    """On a one-process mesh a field handed over as ``frame_shards``
    writes the same file as ``concat_shards``."""
    mesh = make_mesh(devices=["cpu"] * 3)
    rng = numpy.random.RandomState(5)
    field = tuple(torch.from_numpy(rng.rand(4, 3).astype(numpy.float32))
                  for _ in range(3))
    files = {}
    for name, value in (("concat", concat_shards(field)),
                        ("frame", frame_shards(field, mesh))):
        files[name] = tmp_path / (name + ".gsd")
        with ShardedFrameWriter(str(files[name]), application="t",
                                comm=SingleComm()) as w:
            w.write_frame({"particles/position": value})
    assert files["concat"].read_bytes() == files["frame"].read_bytes()


def test_resume_distributed_over_ranks(tmp_path):
    """Each of 2 thread ranks resumes the last frame onto its own shard of
    a mesh over the ranks (the file opened collectively), and both append
    their shards of the next frame through the writer over the ranks."""
    from tpgsd_torch.sph import distribute_state, resume_distributed
    from tpgsd_torch.sph.cells import CellGrid
    from tpgsd_torch.sph.step import SPHState

    path = str(tmp_path / "resume.gsd")
    rng = numpy.random.RandomState(2)
    x = rng.uniform(0.05, 1.95, (40, 3)).astype(numpy.float32)
    x[:, 1:] /= 2
    v = rng.randn(40, 3).astype(numpy.float32)
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                    capacity=16)
    with ShardedFrameWriter(path, application="t", comm=SingleComm()) as w:
        for i in range(2):
            w.write_frame({"particles/position": x + i,
                           "particles/velocity": v}, step=10 + i)
    whole, cap = distribute_state(SPHState(x=x + 1, v=v), grid,
                                  make_mesh(devices=["cpu"] * 2))
    got = {}

    def run(rank, comm):
        mesh = make_mesh(devices=["cpu"], comm=comm)
        dist, rcap, step, writer = resume_distributed(path, grid, mesh,
                                                      comm=comm)
        got[rank] = (dist, rcap, step, mesh.local)
        writer.write_frame({"particles/position": frame_shards(dist.x, mesh),
                            "log/pid": frame_shards(dist.pid, mesh)},
                           step=step + 1)
        writer.close()

    run_ranks(2, run)
    for rank, (dist, rcap, step, local) in got.items():
        assert (rcap, step, local) == (cap, 11, (rank,))
        assert len(dist.x) == 1
        assert torch.equal(dist.x[0], whole.x[rank])
        assert torch.equal(dist.pid[0], whole.pid[rank])
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 3
        numpy.testing.assert_array_equal(
            f.read_chunk(2, "particles/position"),
            torch.cat(whole.x).numpy())
    assert tpgsd_torch.pypgsd.verify(path, deep=True)["ok"]
