"""Bit-exact GSD v1/v2 on-disk format codec.

Single source of truth for the byte layout of the header, index entries, and
namelist.  Everything here is plain numpy - no JAX, no native code - because
the metadata blocks are tiny; the bandwidth-critical data path lives in
``tpgsd_torch.io`` and ``tpgsd_torch.parallel``.
"""

from .structs import (  # noqa: F401
    MAGIC,
    HEADER_DTYPE,
    HEADER_SIZE,
    INDEX_ENTRY_DTYPE,
    INDEX_ENTRY_SIZE,
    NAME_SIZE,
    INITIAL_INDEX_SIZE,
    INITIAL_NAME_BUFFER_SIZE,
    DEFAULT_MAXIMUM_WRITE_BUFFER_SIZE,
    DEFAULT_INDEX_ENTRIES_TO_BUFFER,
    CURRENT_FILE_VERSION,
    TYPE_TO_DTYPE,
    DTYPE_TO_TYPE,
    sizeof_type,
    make_version,
    split_version,
    new_header,
    pack_header,
    unpack_header,
    new_index_block,
    pack_index,
    unpack_index,
)
from .validate import (  # noqa: F401
    FileCorruptError,
    NotAGSDFileError,
    InvalidVersionError,
    validate_header,
    entry_valid,
    find_index_end,
    validate_index_block,
    parse_namelist,
    pack_namelist_v2,
    sort_index,
)
