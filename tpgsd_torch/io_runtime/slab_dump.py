"""Pipelined frame dumps from inside the slab-sequential step (torch
counterpart of ``tpgsd.io_runtime.slab_dump``).

A whole-frame dump at scales past the global layout serializes: the slab
loop finishes the step, then a multi-GB device-to-host copy runs with
the card idle.  :class:`SlabDumpChannel` is the host side of
``make_slab_step_fn(..., slab_emit=chan.slab_emit)``: each slab's window
of final integrated rows is copied to pinned host memory on a side CUDA
stream while later slabs compute, a host thread scatters it by particle
id into a frame buffer (in slab order, so a later slab's rows overwrite
an earlier slab's halo rows, the "last writer wins" rule of the
device-side compaction), and the completed frame goes to the async
writer thread.  The card computes slab s + 1 while slab s's rows cross
the link and an earlier frame's bytes reach the disk.

The reference delivers each window through an ordered ``io_callback``
and probes whether the backend delivers those (``io_callback_supported``).
Here emission is a side stream and one host thread, which every CUDA
build has, so there is no probe.  Pinned memory is a ring of
:data:`RING` window buffers: a buffer is reused only after its host
scatter is done, so the slab loop waits on the host when every buffer
is in flight.  On
the CPU the copy into the ring is synchronous; the host thread is the
same.

Example::

    chan = SlabDumpChannel(
        ShardedFrameWriter(path, comm=SingleComm()), n=db.n, n_slabs=32,
        keys=("position", "velocity"),
    )
    step = make_slab_step_fn(grid, params, n_slabs=32,
                             slab_emit=chan.slab_emit)
    state, aux = step(state, chan.dump(i))     # emitting step
    state, aux = step(state, chan.no_dump())   # silent step
    ...
    chan.close()
"""

import logging
import queue
import threading
import time
import warnings
from typing import NamedTuple

import numpy
import torch

from .dump import AsyncDumpRunner

logger = logging.getLogger("tpgsd_torch.io_runtime")

#: payload column layout emitted by ``make_slab_step_fn``'s slab_emit
#: hook: x(3), v(3), rho(1), p(1)
_COLS = {
    "position": ("particles/position", slice(0, 3)),
    "velocity": ("particles/velocity", slice(3, 6)),
    "density": ("particles/density", slice(6, 7)),
    "pressure": ("particles/pressure", slice(7, 8)),
}

_SENTINEL = object()

#: window buffers in flight between the card and the host scatter (at
#: 1e8 particles on 32 slabs one buffer is about 340 MB of pinned memory)
RING = 2


class SlabDump(NamedTuple):
    """The ``dump`` argument of a step built with ``slab_emit``: whether
    it emits, the frame's step number, and the pipe its windows take."""

    emit: bool
    step: int
    pipe: object


class _EmitPipe:
    """Windows from the card to a host callback, in submission order.

    :meth:`submit` copies one window (device tensors) into a free ring
    buffer, on the CUDA device through a side stream that waits for the
    compute stream, and queues the callback; one host thread waits for
    each copy's event, calls the callback with numpy views of the buffer
    and frees the buffer.  A failure on the thread is raised at the next
    :meth:`submit`, :meth:`check`, :meth:`flush` or :meth:`close`; the
    windows queued before it was raised are dropped, so one failure is
    raised once."""

    def __init__(self):
        self._free = queue.Queue()
        for i in range(RING):
            self._free.put(i)
        self._buffers = [None] * RING
        self._work = queue.Queue()
        self._streams = {}
        self._error = None
        # raising a failure starts a new epoch; the thread drops windows
        # of an older one (guarded by the lock, with the error)
        self._epoch = 0
        self._lock = threading.Lock()
        self._closed = False
        #: bytes copied from the card (or the CPU tensors) into the ring
        self.copied_bytes = 0
        #: seconds the host thread spent in callbacks
        self.host_seconds = 0.0
        self._thread = threading.Thread(
            target=self._drain, name="tpgsd-torch-slab-emit", daemon=True
        )
        self._thread.start()

    def _drain(self):
        # the thread frees every buffer it takes, after an error too, so
        # submit, flush and close never wait on a dead callback
        while True:
            item = self._work.get()
            if item is _SENTINEL:
                self._work.task_done()
                return
            fn, step, slab, i, w, done, epoch = item
            try:
                with self._lock:
                    live = self._error is None and epoch == self._epoch
                if live:
                    if done is not None:
                        done.synchronize()
                    buf = self._buffers[i]
                    p0, rows = (int(r) for r in buf["scalars"].tolist())
                    t0 = time.perf_counter()
                    fn(step, slab, p0, rows, buf["pids"][:w].numpy(),
                       buf["payload"][:w].numpy())
                    self.host_seconds += time.perf_counter() - t0
            except BaseException as e:  # raised at the next call
                logger.exception("slab emission failed")
                with self._lock:
                    if epoch == self._epoch:
                        self._error = e
            finally:
                self._free.put(i)
                self._work.task_done()

    def check(self):
        with self._lock:
            err, self._error = self._error, None
            if err is not None:
                self._epoch += 1
        if err is not None:
            raise RuntimeError("slab emission failed") from err

    def _buffer(self, i, w, cols, device):
        """Ring buffer ``i``, (re)made when it is too small for ``w``
        rows: pinned when the window comes from the card."""
        buf = self._buffers[i]
        if buf is None or buf["payload"].shape[0] < w or buf["cols"] != cols:
            pin = device.type == "cuda"
            buf = {
                "payload": torch.empty((w, cols), dtype=torch.float32,
                                       pin_memory=pin),
                "pids": torch.empty((w,), dtype=torch.int32, pin_memory=pin),
                "scalars": torch.empty((2,), dtype=torch.int64,
                                       pin_memory=pin),
                "cols": cols,
            }
            self._buffers[i] = buf
        return buf

    def submit(self, fn, step, slab, p0, rows, pids, payload):
        """Queue ``fn(step, slab, int(p0), int(rows), pids, payload)`` on
        the host thread, ``pids [w]`` int32 and ``payload [w, F]`` float32
        copied off ``payload``'s device (``p0`` and ``rows`` 0-d int64
        tensors there); waits only for a free ring buffer."""
        if self._closed:
            raise ValueError("slab emission pipe is closed")
        self.check()
        i = self._free.get()
        if self._error is not None:
            self._free.put(i)
            self.check()
        w, cols = payload.shape
        buf = self._buffer(i, w, cols, payload.device)
        scalars = torch.stack([p0, rows])
        targets = ((buf["payload"][:w], payload), (buf["pids"][:w], pids),
                   (buf["scalars"], scalars))
        done = None
        if payload.device.type == "cuda":
            dev = payload.device
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            side.wait_event(ready)
            with torch.cuda.stream(side):
                for host, src in targets:
                    host.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            for _, src in targets:
                # the allocator must not hand these to the compute stream
                # before the side stream has read them
                src.record_stream(side)
        else:
            for host, src in targets:
                host.copy_(src)
        self.copied_bytes += sum(s.numel() * s.element_size()
                                 for _, s in targets)
        self._work.put((fn, step, slab, i, w, done, self._epoch))

    def flush(self):
        """Wait until every submitted window has been delivered."""
        self._work.join()
        self.check()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._work.put(_SENTINEL)
        self._thread.join()
        self._buffers = [None] * RING
        self.check()


class SlabDumpChannel:
    """Assemble per-slab emissions into frames and write them async.

    Args:
        writer: a :class:`tpgsd_torch.parallel.ShardedFrameWriter` (or
            compatible); owned by default.
        n: global particle count (frame buffer rows).
        n_slabs: emissions per frame (one per slab): the frame goes to
            the writer thread when the last slab arrives.
        keys: any of ``position, velocity, density, pressure``.
        depth: async writer queue depth (frames in flight).
    """

    def __init__(self, writer, n, n_slabs,
                 keys=("position", "velocity", "density"), depth=2,
                 own_writer=True):
        bad = [k for k in keys if k not in _COLS]
        if bad:
            raise ValueError(
                "unknown dump keys %r (valid: %s)" % (bad, sorted(_COLS))
            )
        self._runner = AsyncDumpRunner(writer, depth=depth,
                                       own_writer=own_writer)
        self._pipe = _EmitPipe()
        self._n = int(n)
        self._n_slabs = int(n_slabs)
        self._keys = tuple(keys)
        self._frame = None  # dict key -> [n(, cols)] host tensor being filled
        self._step = None
        self._slabs_seen = 0
        self._frame_gap = 0
        #: cumulative never-emitted (window-overflow) rows across all
        #: frames - nonzero means written frames hold zero rows
        self.gap_rows = 0
        self._handoff_seconds = 0.0

    # -- device side ---------------------------------------------------- #

    def dump(self, step):
        """The ``dump`` argument that makes this step emit a frame; raises
        a failure of an earlier emission."""
        self._pipe.check()
        return SlabDump(True, int(step), self._pipe)

    def no_dump(self):
        """The ``dump`` argument for a silent step."""
        return SlabDump(False, 0, None)

    # -- host side (called on the emission thread) ---------------------- #

    def slab_emit(self, step, slab, p0, rows, pids, payload):
        """Scatter one slab's window into the frame buffer.

        ``pids[w]`` are global particle ids (-1 past the particle count);
        ``payload[w, 8]`` is ``x(3), v(3), rho, p``, already integrated,
        so rows equal the post-step state exactly.  ``rows`` is the
        slab's true sorted-row count: only the first ``min(rows, w)``
        window rows belong to this slab (the rest are rows of later
        slabs, which their own emissions write).  When ``rows`` exceeds
        ``w`` (the step's counted window overflow, ``aux[3]``) the excess
        rows appear in no emission and stay zero in the written frame:
        warned at frame completion and counted in :attr:`gap_rows`.
        """
        step = int(step)
        slab = int(slab)
        if not 0 <= slab < self._n_slabs:
            raise ValueError(
                "slab index %d outside this channel's n_slabs=%d - the "
                "channel and make_slab_step_fn were built with different "
                "slab counts" % (slab, self._n_slabs)
            )
        if self._frame is None or self._step != step:
            self._begin_frame(step)
        pids = torch.as_tensor(numpy.asarray(pids))
        payload = torch.as_tensor(numpy.asarray(payload))
        w = pids.shape[0]
        self._frame_gap += max(int(rows) - w, 0)
        own = min(max(int(rows), 0), w)
        ids, rows_own = pids[:own].to(torch.int64), payload[:own]
        live = ids >= 0
        if not bool(live.all()):
            ids, rows_own = ids[live], rows_own[live]
        if ids.numel() and int(ids.max()) >= self._n:
            raise ValueError(
                "emitted particle id %d outside this channel's n=%d - the "
                "channel and the step were built for different particle "
                "counts" % (int(ids.max()), self._n)
            )
        for key in self._keys:
            _name, cols = _COLS[key]
            buf = self._frame[key]
            src = rows_own[:, cols]
            buf.index_copy_(0, ids, src[:, 0] if buf.dim() == 1 else src)
        self._slabs_seen += 1
        if self._slabs_seen == self._n_slabs:
            self._finish_frame()

    def _begin_frame(self, step):
        if self._frame is not None:
            # ordered emission makes this reachable only when the step
            # emits more slabs per frame than the channel expects
            warnings.warn(
                "dropping incomplete frame for step %s: saw %d of the "
                "expected %d slab emissions before step %s began - channel "
                "n_slabs mismatch?"
                % (self._step, self._slabs_seen, self._n_slabs, step),
                RuntimeWarning,
            )
        self._step = step
        self._slabs_seen = 0
        self._frame_gap = 0
        self._frame = {}
        for key in self._keys:
            w = _COLS[key][1].stop - _COLS[key][1].start
            shape = (self._n,) if w == 1 else (self._n, w)
            self._frame[key] = torch.zeros(shape, dtype=torch.float32)

    def _finish_frame(self):
        if self._frame_gap:
            self.gap_rows += self._frame_gap
            warnings.warn(
                "window overflow: %d particle rows of step %s were never "
                "emitted and are ZERO in the written frame (the step's "
                "aux[3] counts the same overflow) - rebuild with a wider "
                "window" % (self._frame_gap, self._step),
                RuntimeWarning,
            )
        chunks = {_COLS[k][0]: self._frame[k] for k in self._keys}
        step = self._step
        self._frame = None
        self._step = None
        self._slabs_seen = 0
        self._frame_gap = 0
        # the next frame gets new buffers, so the writer takes these
        # without a copy
        t0 = time.perf_counter()
        self._runner.submit(chunks, step=step, owned=True)
        self._handoff_seconds += time.perf_counter() - t0

    # -- lifecycle ------------------------------------------------------- #

    @property
    def stats(self):
        """The writer thread's :class:`~tpgsd_torch.io_runtime.DumpStats`."""
        return self._runner.stats

    @property
    def d2h_bytes(self):
        """Bytes the emissions copied off the device so far (whole
        windows, their particle ids and two scalars each)."""
        return self._pipe.copied_bytes

    @property
    def emit_host_seconds(self):
        """Seconds the emission thread spent scattering windows (the
        frames' hand-off to the writer excluded)."""
        return self._pipe.host_seconds - self._handoff_seconds

    @property
    def handoff_seconds(self):
        """Seconds the emission thread spent handing completed frames to
        the writer (waiting while ``depth`` frames are in flight)."""
        return self._handoff_seconds

    @property
    def writer(self):
        return self._runner._writer

    def _warn_if_incomplete(self):
        if self._frame is not None:
            warnings.warn(
                "dropping incomplete frame for step %s at flush/close: saw "
                "%d of the expected %d slab emissions - channel n_slabs "
                "mismatch?" % (self._step, self._slabs_seen, self._n_slabs),
                RuntimeWarning,
            )
            self._frame = None
            self._step = None
            self._slabs_seen = 0
            self._frame_gap = 0

    def flush(self):
        """Wait for every queued emission (the copies and their host
        scatter), then drain the writer queue."""
        self._pipe.flush()
        self._warn_if_incomplete()
        self._runner.flush()

    def close(self):
        """Deliver every queued emission, then drain and close the
        writer; raises a failure of either thread."""
        try:
            self._pipe.close()
        finally:
            self._warn_if_incomplete()
            self._runner.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        try:
            self.close()
        except Exception:
            if exc_type is None:
                raise
