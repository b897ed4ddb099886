"""Structured runtime tracing for the I/O paths.

The reference's tracing is a compile-time printf flag
(``PGSD_ACTIVATE_LOGGER``, reference: pgsd/pgsd/pgsd.c:26-27, emitting
``[INFO]: Rank %i -> PGSD: <fn>`` lines at every entry point and every
write site).  tpgsd replaces it with a *runtime* recorder:

* enable with ``TPGSD_TRACE=1`` (stderr lines), ``TPGSD_TRACE=<path>``
  (JSONL file), or programmatically via ``get_tracer().enable(...)``;
* every file-layer write/read/flush records name, offset, bytes, and
  duration; the dump runtime records per-frame timings;
* events carry a monotonic timestamp and the process index, so
  multi-host traces merge by sort;
* spans are also ``torch.profiler.record_function`` ranges, so a
  ``torch.profiler`` trace shows the I/O phases beside the device
  timeline.

This is the port's copy of ``tpgsd/utils/trace.py``.

Overhead when disabled: one attribute check per call site.
"""

import json
import os
import sys
import threading
import time
from contextlib import contextmanager

import torch


def _process_index():
    """Rank of this process in ``torch.distributed`` (0 outside it)."""
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
        evt = {"t": time.monotonic(), "kind": kind, "process": _process_index()}
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
        """Timed span; also a ``torch.profiler.record_function`` range."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            with torch.profiler.record_function("tpgsd:" + kind):
                yield
        finally:
            self.record(kind, seconds=round(time.monotonic() - t0, 6), **fields)


_tracer = TraceRecorder()


def get_tracer():
    """The process-global tracer."""
    return _tracer


def tracing_enabled():
    return _tracer.enabled


def trace_event(kind, **fields):
    """Record one event on the global tracer (no-op when disabled)."""
    _tracer.record(kind, **fields)
