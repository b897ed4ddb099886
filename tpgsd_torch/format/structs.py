"""On-disk struct layouts as numpy structured dtypes.

The layouts are bit-compatible with GSD v1/v2 so that upstream GSD tooling
(OVITO, gsd-vmd, freud, pgsd2vtu) consumes tpgsd output unchanged.

Layout contract (reference: pgsd/pgsd/pgsd.h:143-204 and
pgsd/pgsd/pypgsd.py:50-54):

* header: 256 bytes at offset 0, struct-string ``QQQQQII64s64s80s``
* index entry: 32 bytes, struct-string ``QQqIHBB``
* namelist: v1 = fixed 64 bytes/name; v2 = NUL-separated variable length
* data chunks: raw little-endian N x M arrays of 10 scalar types
"""

import numpy as np

#: Magic value identifying a GSD/PGSD file (reference: pgsd/pgsd/pgsd.c:54).
MAGIC = 0x65DF65DF65DF65DF

#: 256-byte file header (reference: pgsd/pgsd/pgsd.h:143-174).
HEADER_DTYPE = np.dtype(
    [
        ("magic", "<u8"),
        ("index_location", "<u8"),
        ("index_allocated_entries", "<u8"),
        ("namelist_location", "<u8"),
        ("namelist_allocated_entries", "<u8"),
        ("schema_version", "<u4"),
        ("pgsd_version", "<u4"),
        ("application", "S64"),
        ("schema", "S64"),
        ("reserved", "S80"),
    ]
)
HEADER_SIZE = HEADER_DTYPE.itemsize
assert HEADER_SIZE == 256

#: 32-byte index entry (reference: pgsd/pgsd/pgsd.h:182-204).
INDEX_ENTRY_DTYPE = np.dtype(
    [
        ("frame", "<u8"),
        ("N", "<u8"),
        ("location", "<i8"),
        ("M", "<u4"),
        ("id", "<u2"),
        ("type", "u1"),
        ("flags", "u1"),
    ]
)
INDEX_ENTRY_SIZE = INDEX_ENTRY_DTYPE.itemsize
assert INDEX_ENTRY_SIZE == 32

#: v1 name slot width; v2 namelist blocks stay multiples of this
#: (reference: pgsd/pgsd/pgsd.h PGSD_NAME_SIZE; pgsd.c:1272-1276).
NAME_SIZE = 64

#: Initial number of index entries in a new file (reference: pgsd/pgsd/pgsd.c:56-60).
INITIAL_INDEX_SIZE = 128

#: Initial namelist block size in bytes (reference: pgsd/pgsd/pgsd.c:62-66).
INITIAL_NAME_BUFFER_SIZE = 1024

#: Default write-buffer cap in bytes (reference: pgsd/pgsd/pgsd.c:79-84).
DEFAULT_MAXIMUM_WRITE_BUFFER_SIZE = 64 * 1024 * 1024

#: Default number of buffered index entries before a flush
#: (reference: pgsd/pgsd/pgsd.c:85-90).
DEFAULT_INDEX_ENTRIES_TO_BUFFER = 256 * 1024

#: File layer major version written by tpgsd (reference: pgsd/pgsd/pgsd.c:99-102).
CURRENT_FILE_VERSION = 2

#: Maximum number of unique chunk names (ids are uint16;
#: reference: pgsd/pgsd/pgsd.c:1355-1362).
MAX_NAMES = np.iinfo(np.uint16).max  # 65535

#: Chunk element type codes (reference: pgsd/pgsd/pgsd.h:38-69,
#: pgsd/pgsd/pypgsd.py:56-67).
TYPE_TO_DTYPE = {
    1: np.dtype("<u1"),
    2: np.dtype("<u2"),
    3: np.dtype("<u4"),
    4: np.dtype("<u8"),
    5: np.dtype("<i1"),
    6: np.dtype("<i2"),
    7: np.dtype("<i4"),
    8: np.dtype("<i8"),
    9: np.dtype("<f4"),
    10: np.dtype("<f8"),
}
DTYPE_TO_TYPE = {v: k for k, v in TYPE_TO_DTYPE.items()}
# Also accept native-endian aliases on lookup.
for _code, _dt in list(TYPE_TO_DTYPE.items()):
    DTYPE_TO_TYPE[np.dtype(_dt.str.lstrip("<="))] = _code


def sizeof_type(type_code):
    """Size in bytes of one element of the given type code.

    Returns 0 for unknown codes (reference: pgsd/pgsd/pgsd.c:2539-2555).
    """
    dt = TYPE_TO_DTYPE.get(int(type_code))
    return 0 if dt is None else dt.itemsize


def make_version(major, minor):
    """Pack a (major, minor) version into a uint32 (reference: pgsd/pgsd/pgsd.c:1705-1708)."""
    return (int(major) << 16) | int(minor)


def split_version(v):
    """Unpack a uint32 version into (major, minor)."""
    v = int(v)
    return (v >> 16, v & 0xFFFF)


def new_header(application, schema, schema_version):
    """Create a fresh v2 header record for a new file.

    The initial layout is header(256) + zeroed index(128 entries) +
    zeroed namelist(1024 bytes) (reference: pgsd/pgsd/pgsd.c:1434-1471).

    Args:
        application: generating application name (truncated to 63 chars).
        schema: schema name (truncated to 63 chars).
        schema_version: packed uint32 (use :func:`make_version`).
    """
    h = np.zeros((), dtype=HEADER_DTYPE)
    h["magic"] = MAGIC
    h["pgsd_version"] = make_version(CURRENT_FILE_VERSION, 0)
    # S64 assignment truncates to 64 bytes; enforce a NUL terminator at 63
    # like the reference's strncpy(..., 63) (pgsd/pgsd/pgsd.c:1440-1443).
    h["application"] = application.encode("utf-8")[: NAME_SIZE - 1]
    h["schema"] = schema.encode("utf-8")[: NAME_SIZE - 1]
    h["schema_version"] = schema_version
    h["index_location"] = HEADER_SIZE
    h["index_allocated_entries"] = INITIAL_INDEX_SIZE
    h["namelist_location"] = HEADER_SIZE + INDEX_ENTRY_SIZE * INITIAL_INDEX_SIZE
    h["namelist_allocated_entries"] = INITIAL_NAME_BUFFER_SIZE // NAME_SIZE
    return h


def pack_header(header):
    """Serialize a header record to 256 bytes."""
    return header.tobytes()


def unpack_header(raw):
    """Deserialize 256 bytes into a header record (no validation)."""
    if len(raw) != HEADER_SIZE:
        raise IOError("short read: expected %d header bytes, got %d" % (HEADER_SIZE, len(raw)))
    return np.frombuffer(raw, dtype=HEADER_DTYPE, count=1)[0].copy()


def new_index_block(n_entries):
    """A zeroed index block of ``n_entries`` entries."""
    return np.zeros(n_entries, dtype=INDEX_ENTRY_DTYPE)


def pack_index(entries):
    """Serialize an array of index entries to bytes."""
    return np.ascontiguousarray(entries, dtype=INDEX_ENTRY_DTYPE).tobytes()


def unpack_index(raw):
    """Deserialize bytes into an array of index entries."""
    return np.frombuffer(raw, dtype=INDEX_ENTRY_DTYPE).copy()
