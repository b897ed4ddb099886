"""Header/index/namelist validation and parsing.

Mirrors the corruption checks the reference performs on open
(reference: pgsd/pgsd/pgsd.c:414-450, 661-704, 1504-1529) so that tpgsd
detects torn frames and garbage files the same way upstream readers do.
"""

import numpy as np

from . import structs
from .structs import (
    MAGIC,
    NAME_SIZE,
    INDEX_ENTRY_DTYPE,
    make_version,
    sizeof_type,
)


class NotAGSDFileError(RuntimeError):
    """The file does not begin with the GSD magic number."""


class InvalidVersionError(RuntimeError):
    """The file layer version cannot be read by this library."""


class FileCorruptError(RuntimeError):
    """The file fails an internal consistency check."""


def validate_header(header, file_size=None, name=""):
    """Validate a header record; raise on failure.

    Accepts file versions v1.x, v2.x and legacy v0.3; rejects >= 3.0
    (reference: pgsd/pgsd/pgsd.c:1504-1529).
    """
    if int(header["magic"]) != MAGIC:
        raise NotAGSDFileError("Not a GSD file: " + str(name))
    v = int(header["pgsd_version"])
    if v < make_version(1, 0) and v != make_version(0, 3):
        raise InvalidVersionError("Unsupported GSD file version: " + str(name))
    if v >= make_version(3, 0):
        raise InvalidVersionError("Unsupported GSD file version: " + str(name))
    if file_size is not None:
        namelist_end = int(header["namelist_location"]) + NAME_SIZE * int(
            header["namelist_allocated_entries"]
        )
        if namelist_end > file_size:
            raise FileCorruptError("namelist extends past end of file: " + str(name))
        index_end = int(header["index_location"]) + structs.INDEX_ENTRY_SIZE * int(
            header["index_allocated_entries"]
        )
        if index_end > file_size:
            raise FileCorruptError("index extends past end of file: " + str(name))


def entry_valid(entry, n_names=None, file_size=None):
    """True when a single index entry passes the validity checks.

    (reference: pgsd/pgsd/pgsd.c:414-450 and pgsd/pgsd/pypgsd.py:179-196)
    """
    if sizeof_type(entry["type"]) == 0:
        return False
    if int(entry["M"]) == 0:
        return False
    if int(entry["flags"]) != 0:
        return False
    if int(entry["location"]) <= 0:
        return False
    if n_names is not None and int(entry["id"]) >= n_names:
        return False
    if file_size is not None:
        end = int(entry["location"]) + int(entry["N"]) * int(entry["M"]) * sizeof_type(
            entry["type"]
        )
        if end > file_size:
            return False
    return True


def find_index_end(index):
    """Number of used entries in an index block.

    ``location == 0`` marks the first unused entry; used entries always
    precede unused ones, so binary search for the boundary
    (reference: pgsd/pgsd/pgsd.c:661-704).
    """
    loc = np.asarray(index["location"])
    # searchsorted on the "is unused" indicator: used entries (loc != 0)
    # map to 0, unused to 1; the boundary is the count of used entries.
    return int(np.searchsorted(loc == 0, True))


def validate_index_block(index, n_used, n_names=None, file_size=None, name=""):
    """Validate the used prefix of an index block; raise on failure.

    Checks per-entry validity plus the monotone-nondecreasing frame
    invariant (reference: pgsd/pgsd/pgsd.c:663-689; pypgsd.py:169-175).
    """
    used = index[:n_used]
    if n_used == 0:
        return
    # vectorized per-entry checks: open latency must stay flat for
    # indexes with 10^5+ entries
    sizes = np.array(
        [sizeof_type(t) for t in range(256)], dtype=np.uint64
    )[used["type"]]
    ok = (
        (sizes != 0)
        & (used["M"] != 0)
        & (used["flags"] == 0)
        & (used["location"] != 0)
    )
    if n_names is not None:
        ok &= used["id"] < n_names
    if file_size is not None:
        # overflow-safe bounds check: location + N*M*itemsize <= file_size
        # computed as N <= (file_size - location) // (M * itemsize) so a
        # corrupt entry with N*M*itemsize >= 2^64 cannot wrap uint64 and
        # slip past (M is u32 and itemsize <= 8, so the divisor itself
        # never wraps)
        fs = np.uint64(file_size)
        loc = used["location"].astype(np.uint64)  # negative -> huge -> bad
        ok &= loc <= fs
        avail = np.where(loc <= fs, fs - loc, np.uint64(0))
        per_row = used["M"].astype(np.uint64) * sizes
        max_rows = avail // np.maximum(per_row, np.uint64(1))
        ok &= used["N"] <= max_rows
    if not ok.all():
        i = int(np.argmin(ok))
        raise FileCorruptError(
            "Corrupt GSD file (invalid index entry %d): %s" % (i, name)
        )
    frames = np.asarray(used["frame"], dtype=np.uint64)
    if n_used > 1 and np.any(frames[1:] < frames[:-1]):
        raise FileCorruptError("Corrupt GSD file (index frames not sorted): " + str(name))


def parse_namelist(raw, version):
    """Parse the namelist block into an ordered list of names.

    v1 stores names in fixed 64-byte slots; v2 stores NUL-separated
    variable-length names.  In both, an empty name terminates the list
    (reference: pgsd/pgsd/pgsd.c:1573-1607).

    Returns:
        (names, used_bytes): the names in id order, and the number of
        namelist bytes in use (the reference's ``file_names.data.size``).
    """
    names = []
    pos = 0
    n = len(raw)
    if version < make_version(2, 0):
        while pos < n:
            slot = raw[pos : pos + NAME_SIZE]
            end = slot.find(b"\x00")
            if end == 0:
                break
            if end == -1:
                end = len(slot)
            names.append(slot[:end].decode("utf-8"))
            pos += NAME_SIZE
    else:
        while pos < n:
            end = raw.find(b"\x00", pos)
            if end == pos:
                break
            if end == -1:
                # The reference requires the block to end in a NUL
                # (pgsd/pgsd/pgsd.c:1561-1566).
                raise FileCorruptError("namelist does not end in NUL")
            names.append(raw[pos:end].decode("utf-8"))
            pos = end + 1
    return names, pos


def pack_namelist_v2(names, reserved):
    """Pack names into a v2 namelist block of ``reserved`` bytes.

    Names are NUL-terminated and concatenated; the remainder is zero.
    ``reserved`` must be a multiple of NAME_SIZE
    (reference: pgsd/pgsd/pgsd.c:1272-1276).
    """
    if reserved % NAME_SIZE != 0:
        raise ValueError("namelist reserved size must be a multiple of %d" % NAME_SIZE)
    buf = bytearray(reserved)
    pos = 0
    for name in names:
        b = name.encode("utf-8")
        if pos + len(b) + 1 > reserved:
            raise ValueError("names do not fit in reserved namelist space")
        buf[pos : pos + len(b)] = b
        pos += len(b) + 1
    return bytes(buf)


def sort_index(entries):
    """Sort index entries by (frame, id) - the v2 on-disk order.

    (reference: heapsort at pgsd/pgsd/pgsd.c:799-953, key (frame,id))
    """
    entries = np.asarray(entries, dtype=INDEX_ENTRY_DTYPE)
    order = np.lexsort((entries["id"], entries["frame"]))
    return entries[order]
