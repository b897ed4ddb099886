"""The four-card benchmark cell's step (``portbench/systems/mesh_step.py``:
``make_distributed_step_fn`` with ``decomp_axis=1`` on a single-controller
mesh) on four CPU shards, at a small size of its configuration
(``portbench/configs/dambreak-1e8-slab4.json``).

Two steps of a jittered dam break are held to the plain float64
reference (``portbench/reference/sph_summation.py``) within the
configuration's limits; the module's pid-ordered views are held to
``collect_state`` / ``collect_aux`` of the step it wraps; the exchange's
counters to the bytes of the halo planes and migrant buffers; and the
``mesh.*`` phase ranges to their nesting, with no bit of the output
changed by them.  The test marked ``cuda`` holds the step on two or more
cards to the same shards on ``cuda:0``.
"""

import copy
import json
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import compare, inputs  # noqa: E402
from portbench.reference import sph_summation as ref  # noqa: E402
from portbench.systems import mesh_step  # noqa: E402
from tpgsd_torch.parallel import exchange, make_mesh  # noqa: E402
from tpgsd_torch.sph import (  # noqa: E402
    collect_aux,
    collect_state,
    dam_break,
    make_distributed_step_fn,
)
from tpgsd_torch.utils import get_tracer  # noqa: E402

SEED = 2 ** 31 + 4242  # seeds past 32 signed bits must work
N_SIDE = 9  # 1,089 particles; cells (8, 4, 4): one y plane a shard
CAP = 600  # slots a shard, about twice the fullest slab's particles
MESH_RANGES = ("mesh.cells", "mesh.halo", "mesh.density", "mesh.momentum",
               "mesh.migrate")  # and a mesh.rows a shard inside mesh.momentum


def small_cfg(n_side=N_SIDE, shards=4, capacity=CAP):
    """The cell's configuration at ``n_side``: the dam break's own lattice,
    grid and constants (``tpgsd_torch.sph.dam_break``), ``shards`` y-slabs
    and the plain passes the CPU resolves to."""
    cfg = json.loads((REPO / "portbench" / "configs" /
                      "dambreak-1e8-slab4.json").read_text())
    cfg = copy.deepcopy(cfg)
    box, fill, lz = (2.0, 1.0, 1.0), (0.5, 1.0, 0.8), 0.8
    dx = lz / n_side
    h = 1.3 * dx
    counts = [max(1, int(round(box[d] * fill[d] / dx))) for d in range(3)]
    dims = [max(1, int(math.floor(box[d] / (2 * h)))) for d in range(3)]
    c0 = 10 * max(math.sqrt(2 * 9.81 * lz), 1.0)
    k = dam_break(n_side=n_side, capacity="auto",
                  capacity_headroom=cfg["scenario"]["capacity_headroom"],
                  device="cpu", on_device=True).grid.capacity
    cfg["n"] = counts[0] * counts[1] * counts[2]
    cfg["scenario"].update(n_side=n_side, spacing=dx, lattice=counts)
    cfg["grid"].update(cells=dims, capacity=min(max(k, 24), 64),
                       cell_size=max(box[d] / dims[d] for d in range(3)))
    cfg["physics"].update(mass=1000 * dx ** 3, h=h, dt=0.25 * h / c0, c0=c0)
    cfg["mesh"] = dict(cfg["mesh"], shards=shards)
    cfg["capacity"] = capacity
    cfg["resolved"] = dict(cfg["resolved"], use_kernels=False, spill=False)
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    same cores, and these steps are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg():
    return small_cfg()


@pytest.fixture(scope="module")
def run(cfg):
    """The module's program, its first state (velocities N(0, 20^2) m/s:
    particles cross the y faces) and two steps."""
    prog = mesh_step.build(cfg, "cpu")
    x0, _ = inputs.lattice(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(11)
    v0 = 20.0 * torch.randn(x0.shape, generator=g)
    states, auxes = [prog.state(x0, v0)], []
    for _ in range(2):
        s, aux = prog.step(states[-1])
        states.append(s)
        auxes.append(aux)
    return prog, states, auxes


def test_y_slab_step_matches_the_plain_reference(cfg, run):
    prog, states, auxes = run
    assert prog.resolved == cfg["resolved"]
    assert mesh_step.devices_in_use == [torch.device("cpu")]
    params = ref.Params(cfg)
    rows = torch.arange(cfg["n"])
    crossed = 0
    for before, after, aux in zip(states, states[1:], auxes):
        assert [int(o) for o in aux[2:]] == [0] * 8  # cells, migrations
        want = ref.step_rows(before.x, before.v, rows, params)
        got = {"x": after.x, "v": after.v, "rho": aux[0][rows]}
        gaps, _, _ = compare.row_gaps(got, want, cfg)
        for k, gap in gaps.items():
            assert gap <= cfg["limits"][k], (k, gaps)
        slab = [(s.x[:, 1] // 0.25).long() for s in (before, after)]
        crossed += int((slab[0] != slab[1]).sum())
    assert crossed > 0  # the migrants were exchanged and inserted


def test_views_equal_collect_state_and_collect_aux(cfg, run):
    """The module's views gather what the program's own collectors do,
    from the step the port's normal path builds on the same mesh."""
    _, states, auxes = run
    db = dam_break(n_side=N_SIDE, capacity=cfg["grid"]["capacity"],
                   device="cpu")
    step = make_distributed_step_fn(
        db.grid, db.params, make_mesh(devices=["cpu"] * 4), capacity=CAP,
        use_kernels="auto", spill="auto", density_mode="summation",
        decomp_axis=1)
    n = cfg["n"]
    dist, aux = step(states[0].dist)
    got = collect_state(dist, n)
    assert torch.equal(states[1].x, torch.from_numpy(got.x))
    assert torch.equal(states[1].v, torch.from_numpy(got.v))
    # summation mode: the aux rows are the slots of the state stepped
    rho, p, _ = collect_aux(states[0].dist, aux, n, params=db.params)
    assert torch.equal(auxes[0][0].full(), torch.from_numpy(rho))
    assert torch.equal(auxes[0][1].full(), torch.from_numpy(p))


def test_exchange_counts_the_planes_and_migrant_buffers_of_a_step(cfg, run):
    prog, states, _ = run
    prog.reset_launches()
    assert exchange.stats["local_bytes"] == exchange.stats["steps"] == 0
    prog.step(states[0])
    k = cfg["grid"]["capacity"]
    nx, ny, nz = cfg["grid"]["cells"]
    plane = nx * nz  # a y plane of cells, as the swapped step's x plane
    mig_cap = CAP // 4
    faces = 2 * (4 - 1)  # messages a stage between four slabs in a row
    per_face = (plane * k * (7 + 2) * 4  # x | v | live, then rho | p
                + mig_cap * (6 * 4 + 4 + 1))  # x | v, pid, valid
    assert exchange.stats["local_messages"] == 3 * faces
    assert exchange.stats["local_bytes"] == faces * per_face
    assert exchange.stats["steps"] == 1
    assert exchange.stats["messages"] == exchange.stats["bytes"] == 0

    one = mesh_step.build(small_cfg(shards=1, capacity=8 * CAP), "cpu")
    x0, v0 = inputs.lattice(cfg, SEED, "cpu")
    one.reset_launches()
    one.step(one.state(x0, v0))
    assert exchange.stats["local_messages"] == 0
    assert exchange.stats["local_bytes"] == 0
    assert exchange.stats["steps"] == 1


def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(
        ((e.name[len("tpgsd:"):], e.time_range.start, e.time_range.end)
         for e in prof.events() if e.name.startswith("tpgsd:mesh.")),
        key=lambda r: r[1])


def test_mesh_ranges_nest_in_the_step_and_change_no_bit(run):
    prog, states, _ = run
    tracer = get_tracer()
    assert not tracer.enabled
    (s_off, a_off), off = _ranges(lambda: prog.step(states[0]))
    assert off == []
    tracer.enable(keep_events=True)
    try:
        (s_on, a_on), on = _ranges(lambda: prog.step(states[0]))
    finally:
        tracer.disable()
        tracer.events.clear()
    (top,) = [r for r in on if r[0] == "mesh.step"]
    kids = [r for r in on if r[0] != "mesh.step"]
    rows = [r for r in kids if r[0] == "mesh.rows"]
    assert [r[0] for r in kids if r[0] != "mesh.rows"] == list(MESH_RANGES)
    assert all(top[1] <= r[1] and r[2] <= top[2] for r in kids)
    # one range of the per-slot results to particle rows a shard, inside
    # the momentum stage that takes them
    (mom,) = [r for r in kids if r[0] == "mesh.momentum"]
    assert len(rows) == len(states[0].dist.pid)
    assert all(mom[1] <= r[1] and r[2] <= mom[2] for r in rows)
    for a, b in zip([s_off.x, s_off.v, a_off[0].full(), a_off[1].full()],
                    [s_on.x, s_on.v, a_on[0].full(), a_on[1].full()]):
        assert torch.equal(a, b)
    for a, b in zip(s_off.dist.pid, s_on.dist.pid):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_step_over_cards_is_the_step_on_one_card():
    """A 1.2M y-slab step, four shards on the visible cards (shard ``d``
    on ``cuda:{d % cards}``), bit for bit the same shards all on
    ``cuda:0``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    from tpgsd_torch.sph import distribute_state

    cards = torch.cuda.device_count()
    db = dam_break(n_side=92, capacity="auto", capacity_headroom=1.15,
                   device="cuda:0", on_device=True)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    assert grid.dims[1] % 4 == 0, grid.dims
    g = torch.Generator(device="cuda:0").manual_seed(5)
    v = 0.5 * torch.randn(db.state.x.shape, generator=g, device="cuda:0")
    state = db.state._replace(v=v)
    outs = []
    for devices in ([f"cuda:{d % cards}" for d in range(4)],
                    ["cuda:0"] * 4):
        mesh = make_mesh(devices=devices)
        dist, cap = distribute_state(state, grid, mesh, decomp_axis=1)
        step = make_distributed_step_fn(grid, db.params, mesh, capacity=cap,
                                        decomp_axis=1)
        assert step.resolved["use_kernels"] and step.resolved["spill"]
        for _ in range(3):
            dist, aux = step(dist)
        assert [str(t.device) for t in dist.x] == devices
        outs.append([t.cpu() for f in (dist.x, dist.v, dist.pid, aux.rho,
                                       aux.p, aux.cell_overflow,
                                       aux.migrate_overflow) for t in f])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
