"""Host file-I/O backends.

The file layer performs all reads/writes at explicit offsets (``pread`` /
``pwrite``), never through a shared file cursor - the same discipline the
reference enforces with ``MPI_File_read_at`` / ``MPI_File_write_at``
(reference: pgsd/pgsd/pgsd.c:1032-1306).  That makes every operation safe to
run concurrently from multiple threads or host processes at disjoint
offsets, which is what the sharded writer does.

``open_file`` returns the fastest available backend: the native C extension
(``tpgsd_torch.io.native``) when it builds on this machine, else the pure-Python
``os.pread/os.pwrite`` backend.
"""

from .backend import FileHandle, PosixFileHandle, open_file  # noqa: F401
