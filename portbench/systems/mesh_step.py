"""The slab-decomposed step over several cards:
``tpgsd_torch.sph.distributed.make_distributed_step_fn`` on a
single-controller ``Mesh`` (one process drives every shard), the dam
break partitioned by ``distribute_state``.

The configuration's ``mesh`` names the shards, the cards they go on
(shard ``d`` on ``cuda:{d % cards}``; on the CPU every shard on
``cpu``) and the slab axis.  The harness sees the state and the
density through views that gather the shards' live slots in ``pid``
order onto its own device when it reads them (never inside the
window).  Each step ends by making the harness's stream wait, through
CUDA events, for the work the step queued on every other card, so that
a sync of the harness's device closes the window over all of them.
"""

import torch

from . import Program

#: the distinct devices of the last mesh built (read by the metrics
#: that divide by the cards)
devices_in_use = []


def _gather(shards, pids, n, home, fill):
    """``[n, ...]`` on ``home``: row ``pid`` of each shard's live slots,
    ``fill`` where no shard holds the particle."""
    first = shards[0]
    out = torch.full((n,) + tuple(first.shape[1:]), fill, dtype=first.dtype,
                     device=home)
    for t, pid in zip(shards, pids):
        live = pid >= 0
        out[pid[live].to(home, torch.int64)] = t[live].to(home)
    return out


class MeshState:
    """The decomposed state ``dist`` as the harness reads it: ``x`` and
    ``v`` are ``[n, 3]`` in ``pid`` order on ``home``, gathered when
    read."""

    def __init__(self, dist, n, home):
        self.dist, self.n, self.home = dist, n, home

    @property
    def x(self):
        return _gather(self.dist.x, self.dist.pid, self.n, self.home, 0.0)

    @property
    def v(self):
        return _gather(self.dist.v, self.dist.pid, self.n, self.home, 0.0)


class MeshField:
    """One per-slot field of the step's ``DistAux``, in ``pid`` order of
    the slots it describes, gathered onto ``home`` when indexed."""

    def __init__(self, shards, pids, n, home, fill):
        self.shards, self.pids = shards, pids
        self.n, self.home, self.fill = n, home, fill

    def full(self):
        return _gather(self.shards, self.pids, self.n, self.home, self.fill)

    def __getitem__(self, rows):
        return self.full()[rows]


def _home(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build(cfg, device):
    from tpgsd_torch.parallel import exchange, make_mesh
    from tpgsd_torch.sph import (
        SPHState,
        dam_break,
        distribute_state,
        make_distributed_step_fn,
        ops,
    )

    sc, gr, ms = cfg["scenario"], cfg["grid"], cfg["mesh"]
    home = _home(device)
    db = dam_break(n_side=sc["n_side"], capacity="auto",
                   capacity_headroom=sc["capacity_headroom"], device=home,
                   on_device=True)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    params, n = db.params, db.n
    del db
    if (list(grid.dims), grid.capacity) != (gr["cells"], gr["capacity"]):
        raise RuntimeError("the program's grid %s, K=%d is not the "
                           "configuration's %s, K=%d"
                           % (grid.dims, grid.capacity, gr["cells"],
                              gr["capacity"]))
    shards, axis = int(ms["shards"]), int(ms["decomp_axis"])
    if home.type == "cuda":
        devices = [torch.device("cuda", (home.index + d) % ms["cards"])
                   for d in range(shards)]
    else:
        devices = [home] * shards
    mesh = make_mesh(devices=devices)
    devices_in_use[:] = sorted(set(mesh.devices), key=str)
    others = [d for d in devices_in_use if d != home]
    continuity = cfg["density_mode"] == "continuity"
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=cfg["capacity"],
        migrate_cap=cfg.get("migrate_cap"), use_kernels="auto",
        spill="auto", density_mode=cfg["density_mode"], decomp_axis=axis)

    def join():
        """The harness's stream waits for every other card's."""
        for dev in others:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(home).wait_event(ev)

    def mesh_step(view):
        dist, aux = step(view.dist)
        join()
        # summation mode: the aux rows are the slots of the state the step
        # took (before the migrants moved); continuity: of the new state
        pids = dist.pid if continuity else view.dist.pid
        return MeshState(dist, n, home), (
            MeshField(aux.rho, pids, n, home, params.rho0),
            MeshField(aux.p, pids, n, home, 0.0),
            *aux.cell_overflow, *aux.migrate_overflow)

    def state(x, v):
        dist, _cap = distribute_state(SPHState(x=x, v=v), grid, mesh,
                                      capacity=cfg["capacity"],
                                      decomp_axis=axis)
        return MeshState(dist, n, home)

    def reset():
        ops.reset_launch_counts()
        exchange.reset_stats()

    return Program(
        step=mesh_step, state=state, resolved=dict(step.resolved),
        launches=lambda: {k: v for k, v in ops.launch_counts.items() if v},
        reset_launches=reset, n=int(n))
