"""MB/s of the writer thread while it writes (``DumpStats.write_mb_s``
of ``io_runtime/dump.py``: bytes over the thread's busy time in
``write_frame``, through ``parallel/``, ``fl.py`` and ``io/native``)."""


def read(rec):
    stats = rec["dump_stats"]
    if stats is None or not stats.frames:
        return None
    return stats.write_mb_s
