"""Sharded chunk write/read: torch tensors and numpy arrays <-> GSD file
stripes (the port's copy of ``tpgsd.parallel.shard_io``).

Write path: each shard pwrites its rows at ``chunk_location + row_start *
M * itemsize`` - the precomputed offset protocol that replaces the
reference's per-rank ``MPI_File_write_at`` (reference:
pgsd/pgsd/pgsd.c:2225-2237).  One index entry describes the global chunk;
the controller process commits it.

Read path: each process preads its own row stripe (or the rows of each of
its shards) into a host buffer and places it on its device.

With one process per rank, a global array is a :class:`ProcessShards` on
each process: its own shards with their global row starts.  Each process
writes only those; the controller commits the one index entry.
"""

from typing import NamedTuple

import numpy
import torch

from ..format.structs import DTYPE_TO_TYPE, TYPE_TO_DTYPE


def gsd_storable(arr):
    """Coerce ``arr`` to a GSD-storable dtype (single policy for every
    writer): bfloat16/void floats -> float32, oddball ints -> int32."""
    if numpy.dtype(arr.dtype) in DTYPE_TO_TYPE:
        return arr
    target = numpy.float32 if numpy.dtype(arr.dtype).kind in "fV" else numpy.int32
    return numpy.asarray(arr, dtype=target)


def infer_particles_n(chunks, static):
    """Fill ``static['particles/N']`` from the first particles/* chunk
    when absent - the shared first-frame convention of every frame
    writer."""
    n_chunk = next(
        (v for k, v in chunks.items() if k.startswith("particles/")), None
    )
    if n_chunk is not None and "particles/N" not in static:
        static["particles/N"] = numpy.array(
            [n_chunk.shape[0]], dtype=numpy.uint32
        )
    return static


class ProcessShards(NamedTuple):
    """This process's row blocks of one global array (the counterpart of
    a ``jax.Array``'s addressable shards): ``tensors[i]`` (a tensor or
    numpy array) holds the global rows ``starts[i] ..  starts[i] +
    len(tensors[i]) - 1`` of an array of ``shape``.  The other rows
    belong to other processes.  Every writer and
    :func:`read_sharded_chunk` take it; ``shape`` is the global one, so
    :func:`infer_particles_n` reads the global row count off it."""

    starts: tuple
    tensors: tuple
    shape: tuple


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return numpy.asarray(a)


def array_shards(array):
    """Decompose an array into ``([(row_start, host_ndarray), ...], shape)``.

    A numpy array (or array-like) and a ``torch.Tensor`` are each one
    shard at row 0.  A :class:`ProcessShards` gives its own shards, sorted
    by row, a repeated row range once.  A CUDA tensor is copied to the
    host here (a synchronous device-to-host copy; the async dump hands
    over host arrays it has already snapshotted); everything downstream
    is host-side positioned I/O.
    """
    if isinstance(array, ProcessShards):
        shards, seen = [], set()
        for start, t in sorted(zip(array.starts, array.tensors),
                               key=lambda s: s[0]):
            rows = (int(start), int(start) + int(t.shape[0]))
            if rows not in seen:
                seen.add(rows)
                shards.append((int(start), _host(t)))
        return shards, tuple(array.shape)
    arr = _host(array)
    return [(0, arr)], arr.shape


def write_sharded_chunk(file, name, array, n_rows=None):
    """Write ``array`` (torch or numpy, 1-D or 2-D) as one chunk of the
    current frame of ``file`` (a writable :class:`tpgsd_torch.fl.PGSDFile`).

    Args:
        n_rows: true global row count when ``array`` carries zero padding
            (padding rows past ``n_rows`` are stripped and never reach
            the file).
    """
    shards, shape = array_shards(array)
    if len(shape) > 2:
        raise ValueError("GSD can only write 1 or 2 dimensional arrays: " + name)
    N_global = shape[0] if shape else 1
    M = shape[1] if len(shape) == 2 else 1

    if n_rows is not None and n_rows != N_global:
        if n_rows > N_global:
            raise ValueError("n_rows exceeds the array's row count: " + name)
        N_global = int(n_rows)
        clipped = []
        for start, arr in shards:
            valid = min(arr.shape[0], N_global - start)
            if valid > 0:
                clipped.append((start, arr[:valid]))
        shards = clipped

    if shards:
        dtype = numpy.dtype(shards[0][1].dtype)
    else:
        dtype = numpy.dtype(numpy.asarray(array).dtype)
    # bfloat16 and other unlisted dtypes have no GSD code - upcast
    if dtype not in DTYPE_TO_TYPE:
        shards = [(o, gsd_storable(a)) for o, a in shards]
        dtype = numpy.dtype(shards[0][1].dtype) if shards else numpy.dtype(
            gsd_storable(numpy.asarray(array)).dtype
        )
    type_code = DTYPE_TO_TYPE[dtype]

    norm = []
    for start, arr in shards:
        arr = numpy.ascontiguousarray(arr).reshape(-1, M)
        norm.append((start, arr))
    file.write_chunk_shards(name, norm, M=M, type_code=type_code, N_global=N_global)


def stripe_rows(n, rank, size):
    """``(start, stop)`` of process ``rank``'s contiguous row stripe when
    ``n`` rows are split over ``size`` processes (the first ``n % size``
    stripes carry one row more)."""
    base, extra = divmod(n, size)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


def read_sharded_chunk(file, frame, name, rank=0, size=1, device="cuda",
                       like=None):
    """Read process ``rank``'s row stripe of a chunk into a tensor on
    ``device``; returns ``(row_start, tensor)``.  With ``like`` (a
    :class:`ProcessShards`), read the rows of each of its shards instead,
    each onto its tensor's device, and return a :class:`ProcessShards` of
    the same layout (rows past the chunk's end are zeros, as the
    reference's ``pad``).

    Each range is read at its precomputed offset (one batched positioned
    read when the file's handle batches them) - no process reads rows it
    does not own.

    Args:
        file: readable PGSDFile.
        frame (int): frame index.
        name (str): chunk name.
        rank, size: this process and the number of processes the rows
            are split over (:func:`stripe_rows`).
        device: where the stripe is placed (the card unless the caller
            asks for ``"cpu"``).
        like: the layout to read into (the counterpart of the
            reference's ``sharding``).
    """
    chunk = file._find_chunk(frame, name)
    if chunk is None:
        raise KeyError(
            "frame %s / chunk %s not found in: %s" % (frame, name, file.name)
        )
    N = int(chunk["N"])
    M = int(chunk["M"])
    dtype = TYPE_TO_DTYPE[int(chunk["type"])]
    if like is None:
        start, stop = stripe_rows(N, rank, size)
        ranges = [(start, stop - start, device)]
    else:
        ranges = [(int(s), int(t.shape[0]), t.device if isinstance(
            t, torch.Tensor) else "cpu") for s, t in zip(like.starts,
                                                       like.tensors)]
    bufs, reads = [], []
    for start, rows, _dev in ranges:
        buf = numpy.zeros(rows * M, dtype=dtype)
        valid = max(0, min(rows, N - start))
        if valid > 0:
            reads.append((start, valid, buf[: valid * M]))
        bufs.append(buf)
    batched = getattr(getattr(file, "_fh", None), "pread_many", None)
    if batched is not None:
        location = int(chunk["location"])
        batched([(location + start * M * dtype.itemsize, view)
                 for start, _valid, view in reads])
    else:
        for start, valid, view in reads:
            out = file.read_chunk(
                frame, name, N=valid, M=M, offset=start, r_all=True
            )
            view[:] = numpy.asarray(out).reshape(-1)
    placed = [torch.from_numpy(buf.reshape(rows, M) if M > 1 else buf).to(dev)
              for buf, (_s, rows, dev) in zip(bufs, ranges)]
    if like is None:
        return ranges[0][0], placed[0]
    return ProcessShards(starts=tuple(s for s, _r, _d in ranges),
                         tensors=tuple(placed),
                         shape=(N, M) if M > 1 else (N,))


class ShardedTrajectoryReader:
    """Read trajectory frames back as per-process row stripes on a device.

    The read-side pair of :class:`ShardedFrameWriter`: each process reads
    its own stripe of every chunk at its precomputed offset (per-stripe
    fan-out mirrors the reference's all-ranks strided read, reference:
    pgsd/pgsd/pgsd.c:2496-2534).

    Example:
        reader = ShardedTrajectoryReader(path, comm=SingleComm())
        state = reader.read_frame(-1, ["particles/position",
                                       "particles/velocity"])
    """

    def __init__(self, name, *, comm, device="cuda"):
        """Open ``name`` read-only.

        Args:
            comm: the communicator (required: its ``rank`` of ``size``
                selects this process's stripe).
            device: where the stripes are placed (the card unless the
                caller asks for ``"cpu"``).
        """
        from .. import fl

        self.comm = comm
        self.device = device
        self.file = fl.open(name, "r")

    @property
    def nframes(self):
        return self.file.nframes

    def __len__(self):
        return self.file.nframes

    def chunk_names(self, prefix=""):
        return self.file.find_matching_chunk_names(prefix)

    def read_frame(self, frame, names):
        """Read this process's stripes of ``names`` of frame ``frame``
        (negative indexes from the end); returns ``dict name ->
        (row_start, tensor)``."""
        if frame < 0:
            frame += self.file.nframes
        return {
            name: read_sharded_chunk(
                self.file, frame, name, self.comm.rank, self.comm.size,
                self.device,
            )
            for name in names
        }

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()


class ShardedFrameWriter:
    """Stream frames of tensors or arrays into a hoomd-schema file.

    The production dump path: you hand it a dict of chunks each step; it
    writes every shard at its offset and completes the frame.
    Unlike :class:`tpgsd_torch.hoomd.HOOMDTrajectory` there is no default/dedup
    scan - every passed chunk is written - which is what a fixed-cadence
    simulation dump wants (the reference's C write loop works the same
    way: pgsd/scripts/benchmark-write.cc:86-130).

    Example:
        writer = ShardedFrameWriter(path, comm=SingleComm(),
                                    static={"configuration/box": box})
        for step in range(n):
            state = sph_step(state)
            writer.write_frame(
                {"particles/position": state.x, "particles/velocity": state.v},
                step=step,
            )
        writer.close()
    """

    def __init__(
        self,
        name,
        mode="w",
        application="tpgsd_torch.parallel",
        schema="hoomd",
        schema_version=(1, 4),
        static=None,
        *,
        comm,
    ):
        """``comm`` is required: nothing here asks a runtime how many
        processes there are (pass ``SingleComm()`` in one process)."""
        from .. import fl

        self.file = fl.open(
            name,
            mode,
            application=application,
            schema=schema,
            schema_version=list(schema_version),
            comm=comm,
        )
        self._static = dict(static or {})
        self._static_written = False

    def write_frame(self, chunks, step=None):
        """Write one frame: every chunk in ``chunks`` plus, on the first
        frame, the static chunks (box, types, N, ...).

        Args:
            chunks: dict mapping chunk name -> torch tensor, numpy array
                or :class:`ProcessShards` (this process's shards: with
                one process per rank, each writes only its own).
            step: optional ``configuration/step`` value.
        """
        if step is not None:
            self.file.write_chunk(
                "configuration/step",
                numpy.array([step], dtype=numpy.uint64),
                write_all=False,
            )
        if not self._static_written:
            infer_particles_n(chunks, self._static)
            for name, value in self._static.items():
                self.file.write_chunk(name, numpy.asarray(value), write_all=False)
            self._static_written = True
        batch = getattr(self.file, "batched_writes", None)
        if batch is not None:
            # combine the frame's chunk writes into one threaded batch
            with batch():
                for name, array in chunks.items():
                    write_sharded_chunk(self.file, name, array)
        else:
            for name, array in chunks.items():
                write_sharded_chunk(self.file, name, array)
        self.file.end_frame()

    def flush(self):
        self.file.flush()

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()
