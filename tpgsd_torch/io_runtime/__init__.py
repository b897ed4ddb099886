"""Async trajectory dump of torch tensors: overlap device compute with
host I/O (counterpart of ``tpgsd.io_runtime``'s ``dump``, ``jit_dump``
and ``slab_dump`` modules)."""

from .dump import AsyncDumpRunner, DumpStats, run_dump_loop
from .jit_dump import JitDumpChannel, scan_simulate, scan_simulate_adaptive
from .slab_dump import SlabDumpChannel

__all__ = [
    "AsyncDumpRunner",
    "DumpStats",
    "JitDumpChannel",
    "SlabDumpChannel",
    "run_dump_loop",
    "scan_simulate",
    "scan_simulate_adaptive",
]
