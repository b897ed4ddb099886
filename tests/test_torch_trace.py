"""The port's phase ranges and per-frame dump events
(``tpgsd_torch.utils.trace``): off, they open nothing and change no bit
of a step or a frame; on, every range of the global spill step and of
the slab step appears nested in its step, events lie on the profiler's
clock, and each frame's three dump events are ordered.
"""

import time

import numpy
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.sph import dam_break, make_slab_step_fn, make_step_fn
from tpgsd_torch.utils import get_tracer

CPU = "cpu"
N_SLABS = 7  # the n_side=8 dam break has 7 cell planes along x
STEP_RANGES = ("step.cells", "step.density", "step.momentum",
               "step.surface_tension", "step.finish", "step.rows")
SLAB_RANGES = ("slab.sort", "slab.tiers", "slab.pairs", "slab.window",
               "slab.rows", "slab.finish")


@pytest.fixture(scope="module")
def scenario():
    return dam_break(n_side=8, capacity=24, device=CPU)


@pytest.fixture
def tracer():
    tracer = get_tracer()
    assert not tracer.enabled
    yield tracer
    tracer.disable()
    tracer.events.clear()


def steps(db):
    """The global spill step with surface tension (every range of the
    global table) and the slab step."""
    return {
        "spill": make_step_fn(db.grid, db.params, spill=True,
                              surface_tension=0.05, device=CPU),
        "slab": make_slab_step_fn(db.grid, db.params, N_SLABS, spill=True,
                                  device=CPU),
    }


def profiled(fn):
    """``(fn(), tpgsd ranges as (name, start_us, end_us), trace origin in
    ns)`` of one CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(
        ((e.name[len("tpgsd:"):], e.time_range.start, e.time_range.end)
         for e in prof.events() if e.name.startswith("tpgsd:")),
        key=lambda r: r[1])
    return out, ranges, prof.profiler.kineto_results.trace_start_ns()


def flat(out):
    state, aux = out
    return [t for t in (state.x, state.v, state.rho, *aux) if t is not None]


@pytest.mark.parametrize("name", ["spill", "slab"])
def test_ranges_off_open_nothing_and_change_no_bit(name, scenario, tracer):
    step = steps(scenario)[name]
    off, ranges, _ = profiled(lambda: step(scenario.state))
    assert ranges == []
    assert tracer.range("step") is tracer.range("slab.step")
    tracer.enable(keep_events=True)
    on, ranges, _ = profiled(lambda: step(scenario.state))
    assert ranges
    for a, b in zip(flat(off), flat(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_every_range_nests_in_its_step(scenario, tracer):
    tracer.enable(keep_events=True)
    spill, slab = steps(scenario).values()
    _, ranges, _ = profiled(lambda: spill(scenario.state))
    (top,) = [r for r in ranges if r[0] == "step"]
    kids = [r for r in ranges if r[0] != "step"]
    assert [r[0] for r in kids] == list(STEP_RANGES)
    assert all(inside(r, top) for r in kids)
    # the rows of the per-slot results are taken inside the finish
    assert inside(kids[-1], kids[-2])

    _, ranges, _ = profiled(lambda: slab(scenario.state))
    (top,) = [r for r in ranges if r[0] == "slab.step"]
    kids = [r for r in ranges if r[0] != "slab.step"]
    assert all(inside(r, top) for r in kids)
    names = [r[0] for r in kids]
    assert names == (["slab.sort"]
                     + ["slab.tiers", "slab.pairs", "slab.window",
                        "slab.rows"] * N_SLABS
                     + ["slab.finish"])
    assert {r[0] for r in kids} == set(SLAB_RANGES)
    windows = [r for r in kids if r[0] == "slab.window"]
    rows = [r for r in kids if r[0] == "slab.rows"]
    assert all(inside(r, w) for r, w in zip(rows, windows, strict=True))
    assert tracer.events == []  # a range records no event


def test_an_event_lies_inside_its_range_on_the_trace_clock(tracer):
    tracer.enable(keep_events=True)

    def marked():
        with tracer.range("marked"):
            time.sleep(0.002)
            tracer.record("mark")
            time.sleep(0.002)

    _, ranges, origin = profiled(marked)
    (rng,) = ranges
    (event,) = tracer.events
    assert "t" not in event
    at_us = (event["t_ns"] - origin) / 1e3
    assert rng[1] <= at_us <= rng[2]


def frames(n=4, rows=50):
    g = torch.Generator().manual_seed(7)
    return [{"particles/position": torch.rand((rows, 3), generator=g),
             "particles/density": torch.rand(rows, generator=g)}
            for _ in range(n)]


def dump(path, chunks_of):
    with AsyncDumpRunner(ShardedFrameWriter(str(path),
                                            comm=SingleComm())) as runner:
        for i, chunks in enumerate(chunks_of):
            runner.submit(chunks, step=10 * i)
        runner.flush()


def test_dump_events_are_ordered_and_frames_unchanged(tmp_path, tracer):
    chunks_of = frames()
    dump(tmp_path / "off.gsd", chunks_of)
    tracer.enable(keep_events=True)
    _, ranges, origin = profiled(lambda: dump(tmp_path / "on.gsd",
                                              chunks_of))
    assert ((tmp_path / "off.gsd").read_bytes()
            == (tmp_path / "on.gsd").read_bytes())
    by_kind = {}
    for e in tracer.events:
        if e["kind"].startswith("dump."):
            by_kind.setdefault(e["kind"], {})[e["step"]] = e
    steps_ = [10 * i for i in range(len(chunks_of))]
    for kind in ("dump.submit", "dump.copied", "dump.written"):
        assert sorted(by_kind[kind]) == steps_, kind
    submits = [r for r in ranges if r[0] == "dump.submit"]
    assert len(submits) == len(chunks_of)
    for i, step in enumerate(steps_):
        sub = by_kind["dump.submit"][step]
        assert sub["t_ns"] <= by_kind["dump.copied"][step]["t_ns"] \
            <= by_kind["dump.written"][step]["t_ns"]
        at_us = (sub["t_ns"] - origin) / 1e3
        assert submits[i][1] <= at_us <= submits[i][2]
    kinds = {e["kind"] for e in tracer.events}
    assert kinds & {"write_chunk", "write_batch"}


def test_a_disabled_recorder_records_nothing(tracer):
    x = numpy.ones(8, numpy.float32)
    with tracer.range("anything"):
        tracer.record("anything", bytes=x.nbytes)
    assert tracer.events == []
