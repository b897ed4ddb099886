"""Positioned-I/O file handles.

``PosixFileHandle`` wraps an OS file descriptor with full-read/full-write
loops around ``os.pread``/``os.pwrite`` (both release the GIL).  The native
backend (see ``tpgsd/io/native``) subclasses it to batch multi-shard writes
through ``pwritev`` and a thread pool.
"""

import os
import threading


class FileHandle:
    """Abstract positioned-I/O handle."""

    def pread(self, offset, size):
        raise NotImplementedError

    def pwrite(self, offset, data):
        raise NotImplementedError

    def pwrite_many(self, writes):
        """Write ``[(offset, buffer), ...]``; offsets must be disjoint."""
        for offset, data in writes:
            self.pwrite(offset, data)

    def size(self):
        raise NotImplementedError

    def truncate(self, size):
        raise NotImplementedError

    def fsync(self):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class PosixFileHandle(FileHandle):
    """Positioned I/O over an OS file descriptor."""

    def __init__(self, fd, name=""):
        self.fd = fd
        self.name = name
        self._closed = False

    def pread(self, offset, size):
        """Read exactly ``size`` bytes at ``offset`` (raises IOError on short read)."""
        chunks = []
        remaining = size
        pos = offset
        while remaining > 0:
            b = os.pread(self.fd, remaining, pos)
            if not b:
                raise IOError(
                    "short read at offset %d in %s: wanted %d more bytes"
                    % (pos, self.name, remaining)
                )
            chunks.append(b)
            remaining -= len(b)
            pos += len(b)
        return chunks[0] if len(chunks) == 1 else b"".join(chunks)

    def pread_into(self, offset, buffer):
        """Fill ``buffer`` (writable buffer protocol object) from ``offset``."""
        view = memoryview(buffer).cast("B")
        pos = offset
        filled = 0
        total = view.nbytes
        while filled < total:
            b = os.pread(self.fd, total - filled, pos)
            if not b:
                raise IOError(
                    "short read at offset %d in %s" % (pos, self.name)
                )
            view[filled : filled + len(b)] = b
            filled += len(b)
            pos += len(b)

    def pwrite(self, offset, data):
        """Write all of ``data`` at ``offset``."""
        view = memoryview(data).cast("B")
        pos = offset
        written = 0
        total = view.nbytes
        while written < total:
            n = os.pwrite(self.fd, view[written:], pos)
            written += n
            pos += n
        return total

    def pwrite_many(self, writes, parallel=None):
        """Write ``[(offset, buffer), ...]`` at disjoint offsets.

        With several large buffers, fan the writes out over a small thread
        pool: ``os.pwrite`` releases the GIL, so writes to a fast device (or
        a striped network FS) overlap.  This is the host-side analogue of
        the reference's all-ranks-write-concurrently design
        (reference: pgsd/pgsd/pgsd.c:2225-2237).
        """
        if parallel is None:
            parallel = len(writes) > 1 and sum(
                memoryview(d).nbytes for _, d in writes
            ) > (1 << 22)
        if not parallel or len(writes) <= 1:
            for offset, data in writes:
                self.pwrite(offset, data)
            return

        errors = []

        def work(items):
            try:
                for offset, data in items:
                    self.pwrite(offset, data)
            except BaseException as e:  # propagate to caller
                errors.append(e)

        nthreads = min(len(writes), max(2, (os.cpu_count() or 1)))
        buckets = [writes[i::nthreads] for i in range(nthreads)]
        threads = [
            threading.Thread(target=work, args=(b,), daemon=True)
            for b in buckets
            if b
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def size(self):
        return os.fstat(self.fd).st_size

    def truncate(self, size):
        os.ftruncate(self.fd, size)

    def fsync(self):
        os.fsync(self.fd)

    def close(self):
        if not self._closed:
            self._closed = True
            os.close(self.fd)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_file(name, readonly=False, create=False, exclusive=False, truncate=False):
    """Open ``name`` and return the best available :class:`FileHandle`.

    Args:
        name: path to open.
        readonly: open O_RDONLY instead of O_RDWR.
        create: create the file if it does not exist.
        exclusive: with ``create``, fail if the file exists (O_EXCL).
        truncate: truncate to zero length on open.
    """
    flags = os.O_RDONLY if readonly else os.O_RDWR
    if create:
        flags |= os.O_CREAT
    if exclusive:
        flags |= os.O_EXCL
    if truncate:
        flags |= os.O_TRUNC
    if hasattr(os, "O_CLOEXEC"):
        flags |= os.O_CLOEXEC
    fd = os.open(str(name), flags, 0o644)
    try:
        from .native import NativeFileHandle

        return NativeFileHandle(fd, name=str(name))
    except Exception:
        return PosixFileHandle(fd, name=str(name))
