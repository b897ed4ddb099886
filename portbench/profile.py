"""The traced stretch of a run: one ``torch.profiler`` trace, read into
the record that the per-layer metrics take.

Device busy is the union of the device operations inside one host region
that ends with a device sync; idle is ``1 - busy / wall`` of that region
(the rule of ``chip_smoke.py``'s ``profile_run`` and ``_union_us``,
copied here so that no change to the program moves it).
"""

import contextlib

import torch

#: the benchmark's own host spans; an idle gap of the device is labelled
#: with the innermost one open at its middle
REGION = "portbench.traced"
SPANS = ("portbench.step", "portbench.submit", "portbench.window_end")


def union_us(spans):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(spans):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span(name, on):
    """A host span of the benchmark, recorded only while tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def traced(device):
    """Profile the block; yields a dict that holds, after the block, the
    trace's device operations inside the region (``ops``: name, start,
    end in microseconds), the benchmark's host spans (``spans``) and the
    region's ``start`` / ``end``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    out = {}
    with profile(activities=acts) as prof:
        with record_function(REGION):
            yield out
    events = prof.events()
    region = [e for e in events if e.name == REGION
              and e.device_type == DeviceType.CPU]
    if len(region) != 1:
        raise RuntimeError("trace: %d host regions" % len(region))
    t0, t1 = region[0].time_range.start, region[0].time_range.end
    if on_card:
        dev_ops = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("portbench.")]
    else:  # the CPU tests: the host's operators stand for the device's
        dev_ops = [e for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("aten::")]
    ops = []
    for e in dev_ops:
        s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if f > s:
            ops.append((e.name, s, f))
    if not ops:
        raise RuntimeError("trace: no device operation inside the region")
    out.update(
        ops=ops, start=t0, end=t1,
        spans=[(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CPU and e.name in SPANS],
    )


def short_name(name, width=120):
    """A device operation's name without its return type, argument list
    and anonymous namespace, cut to ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:width]


def breakdown(rec, top=10):
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[label, s], ...]}``:
    the device operations by total time and the longest idle gaps of the
    device, each labelled with the benchmark's span open at its middle."""
    by_name = {}
    for name, s, e in rec["ops"]:
        name = short_name(name)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(s, e) for _, s, e in rec["ops"]])
    gaps, prev = [], rec["start"]
    for s, e in busy + [[rec["end"], rec["end"]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        open_ = [(f - b, n) for n, b, f in rec["spans"] if b <= mid <= f]
        label = min(open_)[1].split(".", 1)[1] if open_ else "host"
        labelled.append([label, (e - s) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": labelled}
