"""Mean busy share of a card over the traced region: the device
operations' durations summed over every card, over (cards x the
region's wall).  Each card runs one stream, whose operations do not
overlap, so the sum is each card's busy time added up; with one device
it is the union of its operations (the CPU tests, whose host operators
nest).  The cards are the distinct devices of the mesh that
``systems/mesh_step.py`` built."""

from portbench import profile
from portbench.systems import mesh_step


def read(rec):
    cards = len(mesh_step.devices_in_use)
    if not cards:
        return None
    spans = [(s, e) for _, s, e in rec["ops"]]
    busy = (profile.union_us(spans) if cards == 1
            else sum(e - s for s, e in spans))
    return 100.0 * busy / (cards * (rec["end"] - rec["start"]))
