"""The port's pure-Python reader and fsck (``tpgsd_torch.pypgsd``, a copy
of ``tpgsd.pypgsd``) against the JAX package's: on a file written by
each package's ``fl``, on one truncated and on one with a corrupt index
entry, both give the same frames, the same errors on open and the same
``verify`` report.  The comparisons are exact (the copy changes imports,
not the format)."""

import os

import numpy
import pytest

import tpgsd.fl
import tpgsd.pypgsd
import tpgsd_torch.fl
import tpgsd_torch.pypgsd
from tpgsd_torch.format import HEADER_SIZE, INDEX_ENTRY_DTYPE, unpack_header

READERS = (tpgsd.pypgsd, tpgsd_torch.pypgsd)


def _write(fl, path, frames=3):
    with fl.open(path, "w", application="t", schema="hoomd",
                 schema_version=(1, 4)) as f:
        for i in range(frames):
            f.write_chunk("particles/position",
                          numpy.arange(30, dtype=numpy.float32).reshape(10, 3)
                          + i)
            f.write_chunk("particles/typeid",
                          numpy.arange(10, dtype=numpy.uint32) % 3)
            f.write_chunk("configuration/step",
                          numpy.array([10 * i], numpy.uint64))
            f.end_frame()


def _read(module, path):
    """``(header fields, every frame's chunks)`` through ``module``'s
    ``PGSDFile``, or the type and message of what it raised."""
    try:
        with module.PGSDFile(open(path, "rb")) as f:
            head = (f.nframes, f.schema, f.schema_version, f.application,
                    f.pgsd_version)
            frames = [
                {name: f.read_chunk(i, name)
                 for name in f.find_matching_chunk_names("")
                 if f.chunk_exists(i, name)}
                for i in range(f.nframes)
            ]
        return head, frames
    except Exception as e:  # the two readers must raise alike
        return type(e).__name__, str(e)


def _same(path):
    """Both packages' readers and deep fsck agree on ``path``; returns the
    port's report."""
    ref, port = (_read(m, path) for m in READERS)
    if isinstance(ref[0], str):
        assert port == ref
    else:
        assert port[0] == ref[0]
        assert len(port[1]) == len(ref[1])
        for got, want in zip(port[1], ref[1]):
            assert got.keys() == want.keys()
            for name in want:
                numpy.testing.assert_array_equal(got[name], want[name])
                assert got[name].dtype == want[name].dtype
    for deep in (False, True):
        reports = []
        for m in READERS:
            with open(path, "rb") as fh:
                reports.append(m.verify(fh, deep=deep))
        assert reports[0] == reports[1]
    return reports[1]


@pytest.mark.parametrize("writer", ["tpgsd", "tpgsd_torch"])
def test_readers_agree_on_a_clean_file(tmp_path, writer):
    path = str(tmp_path / "clean.gsd")
    _write(tpgsd.fl if writer == "tpgsd" else tpgsd_torch.fl, path)
    report = _same(path)
    assert report["ok"] and report["frames"] == 3 and report["chunks"] == 9
    assert tpgsd_torch.pypgsd.verify(path)["ok"]  # a path works too
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        numpy.testing.assert_array_equal(
            f.read_chunk(2, "particles/position")[0], [2.0, 3.0, 4.0])
        with pytest.raises(NotImplementedError, match="read-only"):
            f.write_chunk("x", numpy.zeros(1))


@pytest.mark.parametrize("writer", ["tpgsd", "tpgsd_torch"])
def test_readers_agree_on_a_truncated_file(tmp_path, writer):
    path = str(tmp_path / "trunc.gsd")
    _write(tpgsd.fl if writer == "tpgsd" else tpgsd_torch.fl, path)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 40)
    report = _same(path)
    assert not report["ok"]
    assert any("EOF" in e or "short" in e or "invalid" in e
               for e in report["errors"]), report["errors"]


@pytest.mark.parametrize("writer", ["tpgsd", "tpgsd_torch"])
def test_readers_agree_on_a_corrupt_index_entry(tmp_path, writer):
    path = str(tmp_path / "badidx.gsd")
    _write(tpgsd.fl if writer == "tpgsd" else tpgsd_torch.fl, path)
    with open(path, "r+b") as fh:
        loc = int(unpack_header(fh.read(HEADER_SIZE))["index_location"])
        fh.seek(loc)
        entry = numpy.frombuffer(fh.read(INDEX_ENTRY_DTYPE.itemsize),
                                 dtype=INDEX_ENTRY_DTYPE).copy()
        entry["type"] = 200  # no such type code
        fh.seek(loc)
        fh.write(entry.tobytes())
    report = _same(path)
    assert not report["ok"]
    assert any("invalid" in e for e in report["errors"]), report["errors"]
