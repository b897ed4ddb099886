"""The port's own copy of the GSD write/read-back stack against the JAX
package's: the same frames through both packages' ``ShardedFrameWriter``
give byte-identical files, and each package's ``hoomd.open`` reads the
other's file.  The comparisons are exact (no tolerance): the copy changes
imports, not the format.
"""

import numpy
import pytest
import torch

import tpgsd.hoomd
import tpgsd.parallel
import tpgsd_torch.hoomd
import tpgsd_torch.parallel
from tpgsd.parallel.comm import SingleComm as RefSingleComm
from tpgsd_torch.parallel import (
    ShardedFrameWriter,
    ShardedTrajectoryReader,
    SingleComm,
    array_shards,
    stripe_rows,
)
from tpgsd_torch.utils.trace import TraceRecorder

N = 257
BOX = numpy.array([2.0, 1.0, 1.0, 0.0, 0.0, 0.0], numpy.float32)
CHUNKS = {
    1: ("particles/position",),
    4: ("particles/position", "particles/velocity", "particles/density",
        "particles/pressure"),
}


def _frames(n_frames):
    rng = numpy.random.default_rng(11)
    return [
        {
            name: rng.standard_normal(
                (N, 3) if name.endswith(("position", "velocity")) else N
            ).astype(numpy.float32)
            for name in CHUNKS[n_frames]
        }
        for _ in range(n_frames)
    ]


def _write(module, comm, path, frames, as_tensor=False):
    writer = module.ShardedFrameWriter(
        str(path), application="tpgsd parity", comm=comm,
        static={"configuration/box": BOX},
    )
    with writer:
        for i, frame in enumerate(frames):
            if as_tensor:
                frame = {k: torch.from_numpy(v) for k, v in frame.items()}
            writer.write_frame(frame, step=i)


@pytest.fixture(scope="module", params=[1, 4], ids=["one_frame", "four_frames"])
def both_files(request, tmp_path_factory):
    frames = _frames(request.param)
    tmp = tmp_path_factory.mktemp("files")
    ref, port = tmp / "ref.gsd", tmp / "port.gsd"
    _write(tpgsd.parallel, RefSingleComm(), ref, frames)
    _write(tpgsd_torch.parallel, SingleComm(), port, frames, as_tensor=True)
    return frames, ref, port


def test_both_writers_give_byte_identical_files(both_files):
    _, ref, port = both_files
    assert ref.read_bytes() == port.read_bytes()


@pytest.mark.parametrize("reader", ["ref_reads_port", "port_reads_ref"])
def test_each_package_reads_the_others_file(both_files, reader):
    frames, ref, port = both_files
    hoomd, path = {
        "ref_reads_port": (tpgsd.hoomd, port),
        "port_reads_ref": (tpgsd_torch.hoomd, ref),
    }[reader]
    with hoomd.open(str(path), mode="r") as traj:
        assert len(traj) == len(frames)
        for i, frame in enumerate(traj):
            assert int(frame.configuration.step) == i
            assert frame.particles.N == N
            numpy.testing.assert_array_equal(frame.configuration.box, BOX)
            for name, want in frames[i].items():
                got = getattr(frame.particles, name.split("/")[1])
                numpy.testing.assert_array_equal(got, want)


def test_stripe_reader_returns_the_written_rows(both_files):
    frames, _, port = both_files
    with ShardedTrajectoryReader(str(port), comm=SingleComm()) as reader:
        assert len(reader) == len(frames)
        start, got = reader.read_frame(-1, ["particles/position"])[
            "particles/position"
        ]
    assert start == 0 and isinstance(got, torch.Tensor)
    numpy.testing.assert_array_equal(got.numpy(), frames[-1]["particles/position"])


@pytest.mark.parametrize("n, size", [(10, 3), (9, 3), (2, 4), (0, 2)])
def test_stripe_rows_partition_the_rows(n, size):
    stripes = [stripe_rows(n, rank, size) for rank in range(size)]
    assert stripes[0][0] == 0 and stripes[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(stripes, stripes[1:]))
    lengths = [stop - start for start, stop in stripes]
    assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("kind", ["numpy", "tensor", "strided_tensor"])
def test_array_shards_is_one_host_shard_at_row_zero(kind):
    base = numpy.arange(24, dtype=numpy.float32).reshape(8, 3)
    value = {
        "numpy": base,
        "tensor": torch.from_numpy(base),
        "strided_tensor": torch.from_numpy(numpy.ascontiguousarray(base.T)).t(),
    }[kind]
    shards, shape = array_shards(value)
    assert shape == (8, 3) and len(shards) == 1
    start, host = shards[0]
    assert start == 0 and isinstance(host, numpy.ndarray)
    numpy.testing.assert_array_equal(host, base)


@pytest.mark.parametrize("cls", [ShardedFrameWriter, ShardedTrajectoryReader])
def test_writer_and_reader_require_a_communicator(cls, tmp_path):
    with pytest.raises(TypeError, match="comm"):
        cls(str(tmp_path / "no_comm.gsd"))
    assert not hasattr(tpgsd_torch.parallel, "default_comm")


def test_trace_spans_are_recorded_without_jax(tmp_path):
    tracer = TraceRecorder().enable(keep_events=True)
    with tracer.span("write_frame", frame=3):
        pass
    tracer.disable()
    (event,) = tracer.events
    assert event["kind"] == "write_frame" and event["frame"] == 3
    assert event["process"] == 0 and event["seconds"] >= 0
