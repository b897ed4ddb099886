"""Async trajectory dump of torch tensors: overlap device compute with
host I/O (counterpart of ``tpgsd.io_runtime``'s ``dump`` and ``jit_dump``
modules)."""

from .dump import AsyncDumpRunner, DumpStats, run_dump_loop
from .jit_dump import JitDumpChannel, scan_simulate, scan_simulate_adaptive

__all__ = [
    "AsyncDumpRunner",
    "DumpStats",
    "JitDumpChannel",
    "run_dump_loop",
    "scan_simulate",
    "scan_simulate_adaptive",
]
