"""A plain reader of GSD version 2 files in NumPy, for reading a run's
trajectory back with no code of the program.

Layout (GSD 2.x): a 256-byte header (``QQQQQII64s64s80s``: magic, index
location, index entries allocated, namelist location, namelist entries
allocated of 64 bytes, schema version, file version, application,
schema, reserved); an index of 32-byte entries (``QQqIHBB``: frame, N,
location, M, name id, type, flags) sorted by frame, whose first entry
at location 0 ends it; a namelist of NUL-terminated names, in id order,
ended by an empty name; each chunk N x M little-endian scalars.
"""

import numpy as np

MAGIC = 0x65DF65DF65DF65DF
HEADER = np.dtype([("magic", "<u8"), ("index_location", "<u8"),
                   ("index_allocated", "<u8"), ("namelist_location", "<u8"),
                   ("namelist_allocated", "<u8"), ("schema_version", "<u4"),
                   ("gsd_version", "<u4"), ("application", "S64"),
                   ("schema", "S64"), ("reserved", "S80")])
ENTRY = np.dtype([("frame", "<u8"), ("N", "<u8"), ("location", "<i8"),
                  ("M", "<u4"), ("id", "<u2"), ("type", "u1"),
                  ("flags", "u1")])
TYPES = {1: "<u1", 2: "<u2", 3: "<u4", 4: "<u8", 5: "<i1", 6: "<i2",
         7: "<i4", 8: "<i8", 9: "<f4", 10: "<f8"}


class GSDFile:
    """``frames``, ``names`` and ``read(frame, name)`` of one file."""

    def __init__(self, path):
        self._f = open(path, "rb")
        head = np.frombuffer(self._f.read(HEADER.itemsize), HEADER)[0]
        if int(head["magic"]) != MAGIC:
            raise ValueError("%s: not a GSD file" % path)
        if int(head["gsd_version"]) >> 16 != 2:
            raise ValueError("%s: GSD file version %#x, not 2.x"
                             % (path, int(head["gsd_version"])))
        self.schema = bytes(head["schema"]).rstrip(b"\0").decode()
        self._f.seek(int(head["namelist_location"]))
        raw = self._f.read(int(head["namelist_allocated"]) * 64)
        self.names = []
        for name in raw.split(b"\0"):
            if not name:
                break
            self.names.append(name.decode())
        self._f.seek(int(head["index_location"]))
        index = np.frombuffer(
            self._f.read(int(head["index_allocated"]) * ENTRY.itemsize),
            ENTRY)
        end = np.flatnonzero(index["location"] == 0)
        self._index = index[:end[0] if end.size else index.size]
        if np.any(np.diff(self._index["frame"].astype(np.int64)) < 0):
            raise ValueError("%s: index not sorted by frame" % path)
        self.frames = (int(self._index["frame"][-1]) + 1
                       if self._index.size else 0)

    def entry(self, frame, name):
        """The index entry of chunk ``name`` in ``frame`` (``KeyError``
        if absent)."""
        if name not in self.names:
            raise KeyError(name)
        hit = self._index[(self._index["frame"] == frame)
                          & (self._index["id"] == self.names.index(name))]
        if not hit.size:
            raise KeyError("frame %d has no %s" % (frame, name))
        return hit[-1]

    def shape(self, frame, name):
        """``(N, M, numpy dtype)`` of a chunk, from the index alone."""
        e = self.entry(frame, name)
        return int(e["N"]), int(e["M"]), np.dtype(TYPES[int(e["type"])])

    def read(self, frame, name):
        """The chunk ``name`` of ``frame`` (``KeyError`` if absent)."""
        e = self.entry(frame, name)
        dtype = np.dtype(TYPES[int(e["type"])])
        count = int(e["N"]) * int(e["M"])
        self._f.seek(int(e["location"]))
        data = np.frombuffer(self._f.read(count * dtype.itemsize), dtype)
        if data.size != count:
            raise ValueError("short chunk %s of frame %d" % (name, frame))
        return data if int(e["M"]) == 1 else data.reshape(int(e["N"]),
                                                          int(e["M"]))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
