"""Pure-Python read-only GSD/PGSD file layer (the port's copy of
``tpgsd.pypgsd``, numpy only).

Accepts any binary file-like object - useful for in-memory buffers and for
embedding a reader with zero compiled dependencies.  Interchangeable with
:class:`tpgsd_torch.fl.PGSDFile` for read operations and works with
:class:`tpgsd_torch.hoomd.HOOMDTrajectory`
(reference behavior: pgsd/pgsd/pypgsd.py:21-28).

>>> with tpgsd_torch.pypgsd.PGSDFile(open('simulation.gsd', 'rb')) as f:
...     t = tpgsd_torch.hoomd.HOOMDTrajectory(f)
...     pos = t[0].particles.position
"""

import logging

import numpy

from .format import (
    HEADER_SIZE,
    INDEX_ENTRY_DTYPE,
    INDEX_ENTRY_SIZE,
    NAME_SIZE,
    TYPE_TO_DTYPE,
    FileCorruptError,
    find_index_end,
    parse_namelist,
    split_version,
    unpack_header,
    validate_header,
    entry_valid,
)

logger = logging.getLogger("tpgsd_torch.pypgsd")


class PGSDFile:
    """Read-only GSD/PGSD file access over a file-like object.

    Args:
        file: binary file-like object open for reading.

    Use :mod:`tpgsd_torch.fl` for write access; the two classes are duck-type
    interchangeable for reads (reference: pgsd/pgsd/pypgsd.py:70-102).

    Example:
        with PGSDFile(open('file.gsd', 'rb')) as f:
            if f.chunk_exists(frame=0, name='chunk'):
                data = f.read_chunk(frame=0, name='chunk')
    """

    def __init__(self, file):
        self.__file = file
        logger.info("opening file: %s", file)

        self.__file.seek(0)
        try:
            header_raw = self.__file.read(HEADER_SIZE)
        except UnicodeDecodeError:
            raise IOError(
                "file must be opened in binary mode ('rb'): " + str(file)
            ) from None

        self.__header = unpack_header(header_raw)

        # file size
        self.__file.seek(0, 2)
        file_size = self.__file.tell()
        validate_header(self.__header, file_size=file_size, name=str(file))

        # namelist -> id-ordered dict
        self.__file.seek(int(self.__header["namelist_location"]), 0)
        namelist_raw = self.__file.read(
            int(self.__header["namelist_allocated_entries"]) * NAME_SIZE
        )
        names, _used = parse_namelist(namelist_raw, int(self.__header["pgsd_version"]))
        self.__namelist = {name: i for i, name in enumerate(names)}

        # index: read the whole allocated block in one call, trim at the
        # location==0 sentinel, validate the used prefix
        # (reference semantics: pgsd/pgsd/pypgsd.py:153-175, but a single
        # bulk read instead of a per-entry read loop).
        self.__file.seek(int(self.__header["index_location"]), 0)
        n_alloc = int(self.__header["index_allocated_entries"])
        index_raw = self.__file.read(n_alloc * INDEX_ENTRY_SIZE)
        if len(index_raw) != n_alloc * INDEX_ENTRY_SIZE:
            raise IOError("short read of index block in: " + str(file))
        index = numpy.frombuffer(index_raw, dtype=INDEX_ENTRY_DTYPE)
        n_used = find_index_end(index)
        self.__index = index[:n_used].copy()
        for i in range(n_used):
            if not entry_valid(
                self.__index[i], n_names=len(self.__namelist),
                file_size=file_size,
            ):
                raise FileCorruptError("Corrupt GSD file: " + str(file))
        frames = self.__index["frame"]
        if n_used > 1 and numpy.any(frames[1:] < frames[:-1]):
            raise FileCorruptError("Corrupt GSD file: " + str(file))

        self.__is_open = True

    def close(self):
        """Close the file.

        May be called more than once; subsequent data access raises
        ``ValueError``.
        """
        if self.__is_open:
            logger.info("closing file: %s", self.__file)
            self.__index = None
            self.__namelist = None
            self.__is_open = False
            self.__file.close()

    def end_frame(self):
        """Not implemented - this is a read-only layer."""
        raise NotImplementedError("tpgsd_torch.pypgsd is read-only; use tpgsd_torch.fl to write")

    def write_chunk(self, name, data, offset=None, rank=0, write_all=True):
        """Not implemented - this is a read-only layer."""
        raise NotImplementedError("tpgsd_torch.pypgsd is read-only; use tpgsd_torch.fl to write")

    def flush(self):
        """No-op for a read-only layer."""

    def _find_chunk(self, frame, name):
        """Locate the index entry for (frame, name) or return None.

        Binary search for the rightmost entry at ``frame`` then scan
        backwards for the matching id - correct for v1 (frame-sorted) and
        v2 ((frame,id)-sorted) files
        (reference: pgsd/pgsd/pypgsd.py:226-256).
        """
        match_id = self.__namelist.get(name)
        if match_id is None:
            return None

        index = self.__index
        n = len(index)
        if n == 0:
            return None

        lo, hi = 0, n
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if frame < index[mid]["frame"]:
                hi = mid
            else:
                lo = mid

        cur = lo
        while cur >= 0 and index[cur]["frame"] == frame:
            if index[cur]["id"] == match_id:
                return index[cur]
            cur -= 1
        return None

    def chunk_exists(self, frame, name, write_all=False):
        """Test if a chunk exists.

        Args:
            frame (int): frame index to check.
            name (str): chunk name.
            write_all: accepted for fl-interchangeability, ignored.
        """
        if not self.__is_open:
            raise ValueError("File is not open")
        return self._find_chunk(frame, name) is not None

    def read_chunk(self, frame, name, N=0, M=0, offset=0, r_all=False):
        """Read a data chunk and return it as a numpy array.

        Args:
            frame (int): frame index to read.
            name (str): chunk name.
            N, M, offset, r_all: accepted for fl-interchangeability,
                ignored (always reads the full chunk;
                reference: pgsd/pgsd/pypgsd.py:284-291).
        """
        if not self.__is_open:
            raise ValueError("File is not open")

        chunk = self._find_chunk(frame, name)
        if chunk is None:
            raise KeyError(
                "frame %s / chunk %s not found in: %s" % (frame, name, self.__file)
            )

        dtype = TYPE_TO_DTYPE[int(chunk["type"])]
        size = int(chunk["N"]) * int(chunk["M"]) * dtype.itemsize
        if int(chunk["location"]) == 0:
            raise FileCorruptError(
                "Corrupt chunk: %s / %s in %s" % (frame, name, self.__file)
            )
        if size == 0:
            return numpy.array([], dtype=dtype)

        self.__file.seek(int(chunk["location"]), 0)
        data_raw = self.__file.read(size)
        if len(data_raw) != size:
            raise IOError("short read of chunk data in: " + str(self.__file))

        data = numpy.frombuffer(data_raw, dtype=dtype)
        if int(chunk["M"]) == 1:
            return data
        return data.reshape([int(chunk["N"]), int(chunk["M"])])

    def find_matching_chunk_names(self, match, write_all=False):
        """All chunk names that start with ``match``, in id order."""
        return [key for key in self.__namelist if key.startswith(match)]

    def read_all_chunks(self, frame):
        """Read every chunk of ``frame``; returns dict name -> array
        (fl-interchangeable; see :meth:`tpgsd_torch.fl.PGSDFile.read_all_chunks`)."""
        if not self.__is_open:
            raise ValueError("File is not open")
        index = self.__index
        lo = int(numpy.searchsorted(index["frame"], frame, side="left"))
        hi = int(numpy.searchsorted(index["frame"], frame, side="right"))
        names = list(self.__namelist)
        out = {}
        for entry in index[lo:hi]:
            name = names[int(entry["id"])]
            out[name] = self.read_chunk(frame, name)
        return out

    def __getstate__(self):
        return dict(name=self.name)

    def __setstate__(self, state):
        self.__init__(open(state["name"], "rb"))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    @property
    def name(self):
        """str: name of the underlying file object."""
        return self.__file.name

    @property
    def file(self):
        """The underlying file-like object."""
        return self.__file

    @property
    def mode(self):
        """str: always 'r'."""
        return "r"

    @property
    def pgsd_version(self):
        """tuple[int, int]: file layer version (major, minor)."""
        return split_version(self.__header["pgsd_version"])

    # upstream-GSD-compatible alias
    gsd_version = pgsd_version

    @property
    def schema_version(self):
        """tuple[int, int]: schema version (major, minor)."""
        return split_version(self.__header["schema_version"])

    @property
    def schema(self):
        """str: name of the data schema."""
        return bytes(self.__header["schema"]).rstrip(b"\x00").decode("utf-8")

    @property
    def application(self):
        """str: name of the generating application."""
        return bytes(self.__header["application"]).rstrip(b"\x00").decode("utf-8")

    @property
    def nframes(self):
        """int: number of frames in the file."""
        if not self.__is_open:
            raise ValueError("File is not open")
        if len(self.__index) == 0:
            return 0
        return int(self.__index[-1]["frame"]) + 1

    @property
    def nnames(self):
        """int: number of unique chunk names in the file."""
        if not self.__is_open:
            raise ValueError("File is not open")
        return len(self.__namelist)


def verify(file, deep=True):
    """fsck-style integrity walk of a GSD/PGSD file.

    Tolerant forensic pass (unlike :class:`PGSDFile`, which refuses
    corrupt files outright): validates the header, namelist, and every
    used index entry (bounds, frame monotonicity, name-id references),
    and with ``deep=True`` reads every data chunk's bytes and confirms
    their lengths.  The debug-verification mode the reference's
    defensive consistency checks point toward (reference:
    pgsd/pgsd/pgsd.c:174-202, 414-450).

    Args:
        file: binary file-like object open for reading, or a path.
        deep: also read every chunk's payload (catches truncation the
            index bounds check cannot see on sparse/overlayed files).

    Returns:
        report dict: ``{"ok", "errors": [str...], "frames", "chunks",
        "names", "data_bytes", "file_size"}``.  Never raises on
        corruption - structural problems land in ``errors``.
    """
    from .format import sizeof_type

    if isinstance(file, (str, bytes)) or hasattr(file, "__fspath__"):
        with open(file, "rb") as fh:
            return verify(fh, deep=deep)

    report = {
        "ok": False,
        "errors": [],
        "frames": 0,
        "chunks": 0,
        "names": 0,
        "data_bytes": 0,
        "file_size": 0,
    }
    err = report["errors"].append

    file.seek(0, 2)
    file_size = report["file_size"] = file.tell()
    file.seek(0)
    raw = file.read(HEADER_SIZE)
    if len(raw) < HEADER_SIZE:
        err("file shorter than the %d-byte header" % HEADER_SIZE)
        return report
    header = unpack_header(raw)
    try:
        validate_header(header, file_size=file_size, name="verify")
    except Exception as e:
        err("header: %s" % e)
        return report

    # namelist
    try:
        file.seek(int(header["namelist_location"]))
        nl_raw = file.read(int(header["namelist_allocated_entries"]) * NAME_SIZE)
        names, _used = parse_namelist(nl_raw, int(header["pgsd_version"]))
        report["names"] = len(names)
    except Exception as e:
        err("namelist: %s" % e)
        names = []

    # index
    try:
        file.seek(int(header["index_location"]))
        n_alloc = int(header["index_allocated_entries"])
        idx_raw = file.read(n_alloc * INDEX_ENTRY_SIZE)
        if len(idx_raw) != n_alloc * INDEX_ENTRY_SIZE:
            err("index: short read (%d of %d bytes)"
                % (len(idx_raw), n_alloc * INDEX_ENTRY_SIZE))
        index = numpy.frombuffer(
            idx_raw[: (len(idx_raw) // INDEX_ENTRY_SIZE) * INDEX_ENTRY_SIZE],
            dtype=INDEX_ENTRY_DTYPE,
        )
        n_used = find_index_end(index)
    except Exception as e:
        err("index: %s" % e)
        return report

    last_frame = -1
    for i in range(n_used):
        e = index[i]
        tag = "entry %d (frame %d, id %d)" % (i, e["frame"], e["id"])
        if not entry_valid(e, n_names=len(names), file_size=file_size):
            err(tag + ": invalid (bounds/type/flags/name-id)")
            continue
        if int(e["frame"]) < last_frame:
            err(tag + ": frame order regressed")
        last_frame = max(last_frame, int(e["frame"]))
        size = int(e["N"]) * int(e["M"]) * sizeof_type(int(e["type"]))
        loc = int(e["location"])
        if loc + size > file_size:
            err(tag + ": data [%d, %d) beyond EOF %d" % (loc, loc + size, file_size))
            continue
        if deep and size > 0:
            file.seek(loc)
            got = len(file.read(size))
            if got != size:
                err(tag + ": short data read (%d of %d bytes)" % (got, size))
                continue
        report["chunks"] += 1
        report["data_bytes"] += size
    report["frames"] = last_frame + 1 if n_used else 0
    report["ok"] = not report["errors"]
    return report
