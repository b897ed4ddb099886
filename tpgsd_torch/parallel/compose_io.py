"""Compose-on-commit trajectory writer for object-store filesystems (the
port's copy of ``tpgsd.parallel.compose_io``).

The direct write path (``ShardedFrameWriter`` over ``tpgsd.fl``) issues
concurrent positioned writes into ONE shared file - correct on POSIX
filesystems (and their parallel cousins), but object-store mounts
(GCS-fuse and friends) serialize or reject concurrent writers of a
single object (the multi-host hard-part called out in SURVEY.md
section 7: "may need file-per-host shards + v2-compatible index as a
fallback mode").

This module is that fallback mode, two phases:

1. **Spill (during the run)**: each host process appends its local
   shard bytes to a PRIVATE spill file, strictly sequentially - the
   access pattern every object store supports natively.  No
   coordination, no positioned writes, no shared file.
2. **Compose (at close)**: after a barrier, the controller process
   streams every spill back and writes one bit-compatible GSD v2 file
   through the ordinary single-process file layer (sequential chunk
   appends + one index/namelist commit); downstream GSD tooling reads
   the result unchanged.

Crash consistency: spill records are self-describing and strictly
frame-ordered, and a clean ``close()`` appends an end marker.  Compose
trusts a spill through its last frame only when the marker is present;
without it (a crashed writer) the last started frame is assumed torn
and dropped - the same no-partial-frames discipline as the direct
path (reference: pgsd/pgsd/pgsd.c:663-689 stops the index scan at the
first invalid entry).

Memory: compose streams - two passes over each spill (a header-only
seek scan to find the completion horizon, then a frame-synchronous
data pass), holding one frame's records at a time.
"""

import os
import struct

import numpy

from ..format.structs import DTYPE_TO_TYPE, TYPE_TO_DTYPE
from ..utils.trace import get_tracer
from .shard_io import array_shards, gsd_storable, infer_particles_n

# spill record header: magic, name_len, frame, row_start, n_rows, M,
# type_code, flags, reserved
_REC = struct.Struct("<IIQQQIBBH")
_MAGIC = 0x7D512A0C
_FLAG_ROOT_ONLY = 1
_FLAG_END = 2  # clean-close marker: `frame` = total frames written


class ComposedFrameWriter:
    """Object-store-safe drop-in for :class:`ShardedFrameWriter`.

    Same ``write_frame`` API; the final file appears at ``close()``.

    Example:
        with ComposedFrameWriter(path, comm=SingleComm()) as w:
            for step in range(n):
                state = sph_step(state)
                w.write_frame({"particles/position": state.x}, step=step)
        # path is now a complete, bit-compatible GSD v2 file

    Args:
        name: final trajectory path.
        comm: the communicator (required: the port has no default one;
            ``SingleComm()`` in one process, a
            :class:`~tpgsd_torch.parallel.comm.TorchProcessComm` with one
            process per rank).
        spill_dir: directory for the per-process spill files (default:
            alongside ``name``).  On an object-store mount, point this
            at the mount; each process only ever appends to its own
            object.  Must be readable by the controller at close.
        keep_spills: leave the spill files in place after composing
            (default False: they are deleted).
    """

    def __init__(
        self,
        name,
        application="tpgsd_torch.parallel",
        schema="hoomd",
        schema_version=(1, 4),
        static=None,
        *,
        comm,
        spill_dir=None,
        keep_spills=False,
    ):
        if comm is None:
            raise ValueError(
                "ComposedFrameWriter needs comm= (SingleComm() in one "
                "process): there is no default communicator")
        self.name = str(name)
        self.comm = comm
        self._app = application
        self._schema = schema
        self._schema_version = schema_version
        self._static = dict(static or {})
        self._static_written = False
        self._frame = 0
        self._keep_spills = keep_spills
        base = os.path.basename(self.name)
        d = spill_dir if spill_dir is not None else os.path.dirname(self.name)
        self._spill_paths = [
            os.path.join(d, "%s.spill%d" % (base, r)) for r in range(comm.size)
        ]
        self._fh = open(self._spill_paths[comm.rank], "wb")
        self._closed = False

    # ---- spill phase -----------------------------------------------

    def _append_record(self, name, frame, row_start, arr, flags=0):
        arr = gsd_storable(numpy.ascontiguousarray(arr))
        if arr.ndim > 2:
            raise ValueError(
                "GSD can only write 1 or 2 dimensional arrays: " + name
            )
        m = arr.shape[1] if arr.ndim == 2 else 1
        n_rows = arr.shape[0] if arr.ndim else 1
        name_b = name.encode("utf-8")
        self._fh.write(
            _REC.pack(
                _MAGIC,
                len(name_b),
                frame,
                row_start,
                n_rows,
                m,
                DTYPE_TO_TYPE[arr.dtype],
                flags,
                0,
            )
        )
        self._fh.write(name_b)
        self._fh.write(arr.tobytes())

    def write_frame(self, chunks, step=None):
        """Record one frame: every local shard of every chunk (a tensor,
        a numpy array or a
        :class:`~tpgsd_torch.parallel.shard_io.ProcessShards`), appended
        sequentially to this process's spill."""
        if self._closed:
            raise ValueError("writer is closed")
        if step is not None and self.comm.rank == 0:
            self._append_record(
                "configuration/step",
                self._frame,
                0,
                numpy.array([step], dtype=numpy.uint64),
                flags=_FLAG_ROOT_ONLY,
            )
        if not self._static_written:
            infer_particles_n(chunks, self._static)
            if self.comm.rank == 0:
                for name, value in self._static.items():
                    self._append_record(
                        name,
                        self._frame,
                        0,
                        numpy.asarray(value),
                        flags=_FLAG_ROOT_ONLY,
                    )
            self._static_written = True
        for name, array in chunks.items():
            shards, shape = array_shards(array)
            if len(shape) > 2:
                raise ValueError(
                    "GSD can only write 1 or 2 dimensional arrays: " + name
                )
            m = shape[1] if len(shape) == 2 else 1
            for row_start, arr in shards:
                self._append_record(
                    name, self._frame, row_start, arr.reshape(-1, m)
                )
        self._frame += 1

    def flush(self):
        self._fh.flush()
        os.fsync(self._fh.fileno())

    # ---- compose phase ---------------------------------------------

    def close(self):
        """Finalize the spills and compose the final file (controller).

        Collective: every process barriers before the controller's
        compose and learns its outcome afterwards - a controller
        failure raises on EVERY process instead of hanging the others
        in a barrier.
        """
        if self._closed:
            return
        # clean-close marker: compose may trust this spill's last frame
        self._fh.write(
            _REC.pack(_MAGIC, 0, self._frame, 0, 0, 0, 0, _FLAG_END, 0)
        )
        self.flush()
        self._fh.close()
        self._closed = True
        self.comm.barrier()  # all spills durable before compose
        status = None
        if self.comm.rank == 0:
            try:
                compose(
                    self.name,
                    self._spill_paths,
                    application=self._app,
                    schema=self._schema,
                    schema_version=self._schema_version,
                )
                if not self._keep_spills:
                    for p in self._spill_paths:
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
            except Exception as e:  # propagate to every process below
                status = "%s: %s" % (type(e).__name__, e)
        status = self.comm.bcast(status, root=0)
        if status is not None:
            raise RuntimeError("compose failed on the controller: " + status)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()


def _scan_spill(path, with_data=True):
    """Yield ``(frame, name, row_start, flags, array_or_None)`` records;
    stops cleanly at a torn tail (crashed writer).

    ``with_data=False`` seeks past payloads (header-only pass).
    """
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        pos = 0
        while pos + _REC.size <= size:
            hdr = fh.read(_REC.size)
            if len(hdr) < _REC.size:
                return
            (magic, name_len, frame, row_start, n_rows, m, type_code,
             flags, _r) = _REC.unpack(hdr)
            if magic != _MAGIC:
                return  # torn/corrupt tail
            if flags & _FLAG_END:
                yield frame, "", 0, flags, None
                return  # nothing follows a clean-close marker
            dtype = TYPE_TO_DTYPE.get(type_code)
            payload = n_rows * m * (dtype.itemsize if dtype else 0)
            if dtype is None or pos + _REC.size + name_len + payload > size:
                return
            try:
                name = fh.read(name_len).decode("utf-8")
            except UnicodeDecodeError:
                return  # corrupt name bytes = torn tail
            if with_data:
                data = numpy.frombuffer(fh.read(payload), dtype=dtype)
                yield frame, name, row_start, flags, data.reshape(n_rows, m)
            else:
                fh.seek(payload, 1)
                yield frame, name, row_start, flags, None
            pos += _REC.size + name_len + payload


def _complete_through(path):
    """Last frame of ``path`` that is known COMPLETE.

    With a clean-close end marker, every written frame is complete.
    Without one (crash), the last started frame may be torn - trust
    only the frames before it.
    """
    last_started = -1
    for frame, _name, _rs, flags, _a in _scan_spill(path, with_data=False):
        if flags & _FLAG_END:
            return frame - 1  # marker carries the total frame count
        last_started = max(last_started, frame)
    return last_started - 1


def compose(
    name,
    spill_paths,
    application="tpgsd_torch.parallel",
    schema="hoomd",
    schema_version=(1, 4),
):
    """Stream spill files into one bit-compatible GSD v2 file.

    Two passes, O(one frame) memory: a header-only scan finds the
    completion horizon of each spill (no partial frames ever reach the
    output), then a frame-synchronous pass merges the strictly
    frame-ordered spill streams.
    """
    from .. import fl
    from .comm import SingleComm

    tracer = get_tracer()
    n_frames = min(_complete_through(p) for p in spill_paths) + 1
    tracer.record(
        "compose.start", target=str(name), spills=len(spill_paths),
        frames=n_frames,
    )

    streams = []
    heads = []
    for path in spill_paths:
        it = _scan_spill(path, with_data=True)
        streams.append(it)
        heads.append(next(it, None))

    with fl.open(
        name,
        "w",
        application=application,
        schema=schema,
        schema_version=list(schema_version),
        comm=SingleComm(),
    ) as out:
        for frame in range(n_frames):
            # pull this frame's records from every stream (spills are
            # strictly frame-ordered; rank order fixes name-id order)
            by_name = {}
            order = []
            for i, it in enumerate(streams):
                while heads[i] is not None and heads[i][0] == frame:
                    _f, cname, row_start, flags, arr = heads[i]
                    if not flags & _FLAG_END:
                        if cname not in by_name:
                            by_name[cname] = []
                            order.append(cname)
                        by_name[cname].append((row_start, flags, arr))
                    heads[i] = next(it, None)
            for cname in order:
                recs = sorted(by_name[cname], key=lambda r: r[0])
                if recs[0][1] & _FLAG_ROOT_ONLY:
                    arr = recs[0][2]
                    out.write_chunk(
                        cname,
                        arr if arr.shape[1] > 1 else arr.reshape(-1),
                        write_all=False,
                    )
                    continue
                m = recs[0][2].shape[1]
                n_global = max(start + a.shape[0] for start, _f, a in recs)
                out.write_chunk_shards(
                    cname,
                    [(start, a) for start, _f, a in recs],
                    M=m,
                    type_code=DTYPE_TO_TYPE[recs[0][2].dtype],
                    N_global=n_global,
                )
            out.end_frame()
    tracer.record("compose.done", target=str(name), frames=n_frames)
    return n_frames
