"""Async trajectory dump of torch tensors: overlap device compute with
host I/O (counterpart of ``tpgsd.io_runtime``'s ``dump`` module)."""

from .dump import AsyncDumpRunner, DumpStats, run_dump_loop

__all__ = ["AsyncDumpRunner", "DumpStats", "run_dump_loop"]
