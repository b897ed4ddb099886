"""Structured runtime tracing for the I/O paths and the step.

The reference's tracing is a compile-time printf flag
(``PGSD_ACTIVATE_LOGGER``, reference: pgsd/pgsd/pgsd.c:26-27, emitting
``[INFO]: Rank %i -> PGSD: <fn>`` lines at every entry point and every
write site).  tpgsd replaces it with a *runtime* recorder:

* enable with ``TPGSD_TRACE=1`` (stderr lines), ``TPGSD_TRACE=<path>``
  (JSONL file), or programmatically via ``get_tracer().enable(...)``;
* every file-layer write/read/flush records name, offset, bytes, and
  duration; the dump runtime records three events a frame, each with
  ``step`` (``dump.submit`` on the caller's thread, ``dump.copied``
  once the writer thread holds the frame on the host, ``dump.written``
  once its ``write_frame`` has returned);
* every event carries ``t_ns``, ``time.time_ns()`` when it was recorded
  (a span's end), and the process index.  That is the clock of a
  ``torch.profiler`` trace, whose timestamps are Unix-epoch nanoseconds
  (``prof.profiler.kineto_results.trace_start_ns()`` is its origin), so
  an event can be placed on the trace's timeline.  Events of several
  hosts merge by ``t_ns`` only as far as the hosts' clocks agree;
* in a process that has loaded torch, spans are also
  ``torch.profiler.record_function`` ranges named ``tpgsd:<kind>``, and
  :meth:`TraceRecorder.range` opens such a range and records nothing: it
  marks the phases of the step (``step``, ``step.cells``, ...,
  ``slab.step``, ``slab.sort``, ..., and the decomposed step's
  ``mesh.step`` with ``mesh.cells``, ``mesh.halo``, ``mesh.density``,
  ``mesh.momentum`` and ``mesh.migrate`` nested in it, each over every
  shard of the process) and the dump's ``dump.submit``,
  whose host duration means nothing because the launches are
  asynchronous.  A range opened on a thread other than the one that
  started the profiler does not reach ``prof.events()``, and neither do
  that thread's operators: the file spans on the dump's writer thread
  are seen only through the recorder's own events.  ``TPGSD_TRACE``
  enables the recorder at import, so with it set every profiler trace
  of the process holds these ranges (on the CUDA side too): a reader
  that counts the trace's device operations leaves ``tpgsd:`` names out.

This is the port's copy of ``tpgsd/utils/trace.py``.  Like the file
layers that call it, it imports only the standard library: torch is
taken from ``sys.modules`` where a span, a range or an event needs it,
so the file stack and the command line run on a machine without torch.

Overhead when disabled: one attribute check per call site; ``range``
then returns one shared null context.
"""

import json
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

_NULL = nullcontext()


def _torch():
    """The torch module if this process has loaded it, else None."""
    return sys.modules.get("torch")


def _process_index():
    """Rank of this process in ``torch.distributed`` (0 outside it, and
    in a process without torch)."""
    torch = _torch()
    if torch is None:
        return 0
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class TraceRecorder:
    """Collects structured events; writes them to stderr or a JSONL file."""

    def __init__(self):
        self.enabled = False
        self._sink = None
        self._path = None
        self._lock = threading.Lock()
        self.events = []  # in-memory when no sink
        self._keep = False
        env = os.environ.get("TPGSD_TRACE", "")
        if env:
            self.enable(None if env == "1" else env)

    def enable(self, path=None, keep_events=False):
        """Start recording.  ``path=None`` emits stderr lines; a path
        appends JSONL records; ``keep_events`` also buffers in memory."""
        self.enabled = True
        self._keep = keep_events
        self._path = path
        if path:
            self._sink = open(path, "a")
        return self

    def disable(self):
        self.enabled = False
        if self._sink:
            self._sink.close()
            self._sink = None

    def record(self, kind, **fields):
        if not self.enabled:
            return
        evt = {"t_ns": time.time_ns(), "kind": kind,
               "process": _process_index()}
        evt.update(fields)
        with self._lock:
            if self._keep:
                self.events.append(evt)
            if self._sink is not None:
                self._sink.write(json.dumps(evt) + "\n")
                self._sink.flush()
            elif not self._keep:
                print(
                    "[tpgsd-trace] p%d %s %s"
                    % (
                        evt["process"],
                        kind,
                        " ".join("%s=%s" % (k, v) for k, v in fields.items()),
                    ),
                    file=sys.stderr,
                )

    @contextmanager
    def span(self, kind, **fields):
        """Timed span; also a ``torch.profiler.record_function`` range
        where torch is loaded."""
        if not self.enabled:
            yield
            return
        torch = _torch()
        rng = (_NULL if torch is None
               else torch.profiler.record_function("tpgsd:" + kind))
        t0 = time.monotonic()
        try:
            with rng:
                yield
        finally:
            self.record(kind, seconds=round(time.monotonic() - t0, 6), **fields)

    def range(self, name):
        """A ``torch.profiler.record_function("tpgsd:" + name)`` range
        while the recorder is enabled in a process that has loaded torch;
        it records no event.  Otherwise one shared null context."""
        if not self.enabled:
            return _NULL
        torch = _torch()
        if torch is None:
            return _NULL
        return torch.profiler.record_function("tpgsd:" + name)


_tracer = TraceRecorder()


def get_tracer():
    """The process-global tracer."""
    return _tracer


def tracing_enabled():
    return _tracer.enabled


def trace_event(kind, **fields):
    """Record one event on the global tracer (no-op when disabled)."""
    _tracer.record(kind, **fields)
