"""Version of the tpgsd_torch package (the port's copy of ``tpgsd/version.py``).

The on-disk file-layer version written by tpgsd is GSD v2 (see
``tpgsd_torch.format.structs.CURRENT_FILE_VERSION``); this is the *package*
version (reference: pgsd/pgsd/version.py:12).
"""

version = "1.8.0"
