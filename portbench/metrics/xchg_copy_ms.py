"""Device milliseconds a step in copies between cards, summed over the
cards: the halo planes and migrant buffers that ``parallel/exchange.py``
copies for the exchange stages of ``sph/distributed.py``, from the
trace, by the name CUPTI gives a peer copy."""

#: fragments of the device names of copies between two cards
NAMES = ("Memcpy PtoP",)


def read(rec):
    us = sum(e - s for name, s, e in rec["ops"]
             if any(k in name for k in NAMES))
    return us / rec["steps"] / 1e3 if us else None
