"""Double-buffered asynchronous frame dump of torch tensors (counterpart
of ``tpgsd.io_runtime.dump``).

:class:`AsyncDumpRunner` owns a writer thread and a bounded frame queue.
``submit()`` snapshots the frame and returns; the writer thread waits for
the snapshot and performs the positioned file writes while the device
computes the next step.  A queue bound of ``depth`` frames applies
backpressure so a slow disk cannot pile up unbounded host memory.

Overlap correctness: torch tensors are mutable (the reference relies on
``jax.Array`` being immutable), so ``submit`` copies every tensor at
once: a CUDA tensor into a pinned host buffer with a ``non_blocking``
copy on the current stream, followed by a CUDA event the writer thread
waits on; a CPU tensor by a clone.  Work queued on the stream after
``submit`` cannot change the frame.  The writer receives numpy arrays
(already on the host, so ``tpgsd_torch.parallel`` makes no further
device copy).
"""

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger("tpgsd_torch.io_runtime")

_SENTINEL = object()


@dataclass
class DumpStats:
    """Aggregate dump metrics (mirrors ``tpgsd.io_runtime.DumpStats``)."""

    frames: int = 0
    bytes: int = 0
    write_seconds: float = 0.0  # writer-thread busy time
    wall_seconds: float = 0.0  # first submit -> close
    _t_first: float = field(default=0.0, repr=False)

    @property
    def write_mb_s(self):
        """MB/s sustained by the writer thread while busy."""
        return self.bytes / 1e6 / self.write_seconds if self.write_seconds else 0.0

    @property
    def effective_mb_s(self):
        """MB/s over the whole overlapped wall time."""
        return self.bytes / 1e6 / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def overlap_efficiency(self):
        """Fraction of wall time the writer was busy (1.0 = I/O-bound)."""
        return self.write_seconds / self.wall_seconds if self.wall_seconds else 0.0


def _snapshot(value, owned=False):
    """``(host array or tensor, event or None)``: a copy of ``value``
    that later writes to ``value`` cannot reach, or with ``owned`` a
    host ``value`` itself."""
    if owned and not (isinstance(value, torch.Tensor)
                      and value.device.type == "cuda"):
        return value, None
    if not isinstance(value, torch.Tensor):
        return np.array(value), None
    if value.device.type == "cuda":
        host = torch.empty(
            value.shape, dtype=value.dtype, device="cpu", pin_memory=True
        )
        host.copy_(value, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        return host, event
    return value.detach().clone(), None


def _host_array(snap):
    host, event = snap
    if event is not None:
        event.synchronize()
    return host.numpy() if isinstance(host, torch.Tensor) else host


class AsyncDumpRunner:
    """Stream frames to a trajectory file from a background writer thread.

    Args:
        writer: a :class:`tpgsd_torch.parallel.ShardedFrameWriter`, or
            anything with
            ``write_frame(chunks, step=...)`` / ``flush`` / ``close``.
        depth: max frames in flight (default 2 = classic double buffer).
        own_writer: close ``writer`` when the runner closes (default True).

    Example:
        with AsyncDumpRunner(ShardedFrameWriter(path, comm=SingleComm())) as dump:
            for i in range(steps):
                state, (rho, p, _) = step(state)
                dump.submit({"particles/position": state.x}, step=i)
        print(dump.stats.effective_mb_s)
    """

    def __init__(self, writer, depth=2, own_writer=True):
        self._writer = writer
        self._own_writer = own_writer
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._error = None
        self.stats = DumpStats()
        self._closed = False
        self._thread = threading.Thread(
            target=self._drain, name="tpgsd-torch-dump", daemon=True
        )
        self._thread.start()

    def _drain(self):
        # The thread stays alive until the sentinel even after a writer
        # error: queued frames past the failure are consumed and discarded
        # (each still task_done-ed) so flush() and close() can never hang
        # on a dead writer; the error surfaces at the next call.
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            snaps, step = item
            try:
                if self._error is not None:
                    continue
                t0 = time.perf_counter()
                chunks = {name: _host_array(s) for name, s in snaps.items()}
                self._writer.write_frame(chunks, step=step)
                self.stats.write_seconds += time.perf_counter() - t0
                self.stats.frames += 1
                self.stats.bytes += sum(a.nbytes for a in chunks.values())
            except BaseException as e:  # surface on next submit/close
                logger.exception("async dump failed")
                self._error = e
            finally:
                self._queue.task_done()

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            self._closed = True
            raise RuntimeError("async dump writer failed") from err

    def submit(self, chunks, step=None, owned=False):
        """Snapshot one frame and enqueue it for writing; blocks only
        when ``depth`` frames are already in flight.

        Args:
            chunks: dict chunk name -> torch tensor (CUDA or CPU) or
                array.
            step: optional ``configuration/step`` value.
            owned: the caller hands the host tensors and arrays over and
                never writes them again, so they are queued without a
                copy (CUDA tensors are still copied to the host).
        """
        if self._closed:
            raise ValueError("runner is closed")
        self._check_error()
        if not self.stats._t_first:
            self.stats._t_first = time.perf_counter()
        snaps = {name: _snapshot(value, owned)
                 for name, value in chunks.items()}
        self._queue.put((snaps, step))
        self._check_error()

    def flush(self):
        """Block until every submitted frame is on disk."""
        self._queue.join()
        self._check_error()
        self._writer.flush()

    def close(self):
        """Drain the queue, stop the writer thread, close the file."""
        if self._closed:
            return
        self._closed = True
        if self._thread.is_alive():
            self._queue.put(_SENTINEL)
        self._thread.join()
        if self.stats._t_first:
            self.stats.wall_seconds = time.perf_counter() - self.stats._t_first
        if self._own_writer:
            self._writer.close()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async dump writer failed") from err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if exc_type is None:
            self.close()
        else:  # don't mask the original exception with writer errors
            try:
                self.close()
            except Exception:
                logger.exception("error closing dump runner")


def run_dump_loop(step_fn, state, writer, n_steps, frame_of, depth=2):
    """Couple a step with an async dump: the canonical overlapped loop.

    Args:
        step_fn: ``state -> (state, aux)``.
        state: initial state.
        writer: ShardedFrameWriter (consumed; closed on return).
        n_steps: number of steps == frames.
        frame_of: ``(state, aux, i) -> dict`` building the frame's chunks.
        depth: frames in flight.

    Returns:
        ``(final_state, DumpStats)``.
    """
    with AsyncDumpRunner(writer, depth=depth) as dump:
        for i in range(n_steps):
            state, aux = step_fn(state)
            dump.submit(frame_of(state, aux, i), step=i)
        dump.flush()
    return state, dump.stats
