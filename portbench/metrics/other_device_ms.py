"""Device milliseconds a step outside the pair kernels and the copies to
the host: the step body (cell build, sort and scan, gathers, ``cat``,
integrate) of ``sph/cells.py``, ``sph/step.py``, ``sph/bigstep.py``.
Busy time is the union of the device's operations, so it stays defined
whichever operations the step is made of."""

from portbench import profile
from portbench.metrics import load


def read(rec):
    busy = profile.union_us([(s, e) for _, s, e in rec["ops"]])
    d2h = sum(e - s for name, s, e in rec["ops"] if "DtoH" in name)
    pairs = load("pair_kernels_ms").pair_us(rec)
    return (busy - pairs - d2h) / rec["steps"] / 1e3
