"""Share of the traced region's wall time in which the device ran no
operation: ``1 - busy / wall``, busy the union of its operations."""

from portbench import profile


def read(rec):
    busy = profile.union_us([(s, e) for _, s, e in rec["ops"]])
    return 100.0 * (1.0 - busy / (rec["end"] - rec["start"]))
