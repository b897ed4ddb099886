"""Device milliseconds a step in the pair kernels (``sph/ops.py``,
``csrc/sph_pairs.cu``), from the trace, by kernel name."""

#: fragments of the pair kernels' device names
NAMES = ("_pairs_kernel", "st_normals_kernel", "st_force_kernel")


def pair_us(rec):
    """Microseconds of pair kernels in the traced stretch."""
    return sum(e - s for name, s, e in rec["ops"]
               if any(k in name for k in NAMES))


def read(rec):
    us = pair_us(rec)
    return us / rec["steps"] / 1e3 if us else None
