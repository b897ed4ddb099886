"""Device kernels a step in the trace: what the host dispatches (the
Python of ``sph/step.py`` / ``sph/bigstep.py``).  Copies and fills are
not kernels and are not counted."""


def read(rec):
    n = sum(1 for name, _, _ in rec["ops"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / rec["steps"]
