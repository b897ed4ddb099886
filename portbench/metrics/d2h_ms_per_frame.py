"""Device milliseconds of copies to the host a frame: the dump's
snapshot (``io_runtime/dump.py``), from the trace."""


def read(rec):
    us = sum(e - s for name, s, e in rec["ops"] if "DtoH" in name)
    if not rec["frames"] or not us:
        return None
    return us / rec["frames"] / 1e3
