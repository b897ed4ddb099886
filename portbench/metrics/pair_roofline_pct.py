"""The pair kernels' share of their roofline bound: the bound of the work
the step's pair passes need (``portbench/counts.py``: pairs within the
support and each particle's fields, against the float32 peak and the
HBM bandwidth of one H100) over their device time in the trace."""

from portbench import counts
from portbench.metrics import load


def read(rec):
    us = load("pair_kernels_ms").pair_us(rec)
    if not us:
        return None
    return 100.0 * counts.bound_s(rec["work"]) * rec["steps"] / (us / 1e6)
