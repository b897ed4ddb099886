"""Domain decomposition of the SPH step over a device mesh, with halo
exchange and particle migration (torch counterpart of
``tpgsd.sph.distributed``, ``distributed2d`` and ``distributed3d``).

One staged engine steps every decomposition: the mesh cuts a set of
grid axes into blocks, one a shard, and each shard owns the particles in
its block, in ``cap`` slots with a ``pid`` (-1 for a dead slot).  The
slab step (:func:`make_distributed_step_fn`) cuts x or y
(``decomp_axis``) over a 1-D :class:`~tpgsd_torch.parallel.Mesh`; the
2-D and 3-D block steps (:mod:`tpgsd_torch.sph.distributed2d`,
:mod:`tpgsd_torch.sph.distributed3d`) cut x and y, or x, y and z, over
a block mesh (shard ``i * py + j`` owns block ``(i, j)``).  A step
communicates only

* one cell layer of boundary data across each block face, exchanged one
  decomposed axis at a time, innermost first, so the edge and corner
  cells ride along with the faces exchanged later, and
* the particles that left their block (migration buffers of at most
  ``migrate_cap`` rows a face), in one hop a decomposed axis in axis
  order: a particle received on the x hop takes part in the y hop of the
  same step, so a diagonal (corner) mover arrives in one step.

No global sort and no gather of the whole state.

The reference runs one body on every device at once (``shard_map``) and
exchanges with ``lax.ppermute``, a collective.  Here each process drives
its shards of the mesh (every shard, with one process; its own, with one
process per rank: ``make_mesh(comm=...)``) from a Python loop, and the
exchanges go through :class:`~tpgsd_torch.parallel.exchange.Exchange`: a
copy of a neighbour's layers to the receiving shard's device (a no-op
view when both shards share a device, as they do on a one-GPU machine)
between two shards of one process, a message between processes.  So the
step runs in stages, each over every shard before the next reads a
neighbour's output: (1) the local cell build and the dense tiers, (2)
the halo, (3) the density pass and the exchange of the owners' density
and pressure (summation mode), (4) the momentum pass (with the owners'
surface-tension normals exchanged before the force pass), the rows and
the integration, (5) each migration hop: packing, exchange and
insertion.  Every stage makes new tensors and none writes its inputs,
so no shard reads a neighbour's new state where the reference reads the
old one.  The ends of a non-periodic axis receive zeros, as
``ppermute`` gives to unnamed targets; the zeroed live mask makes them
empty ghosts.  A periodic decomposed axis is a ring (of 1 or 2 shards
too, which exchange with themselves or with their one neighbour both
ways), and after the whole halo the ghost layers across a seam are
shifted by the box length, the corner columns received from another
axis included; the other axes wrap locally, in the pair passes' own
ghost halo (the kernels) or wrapped table (the plain passes).

Each shard lays its particles out on the extended grid of its block (a
ghost layer each side of every decomposed axis) and runs the unchanged
pair passes of :mod:`tpgsd_torch.sph.ops` there: the CUDA kernels when
its tensors are on the card, the plain passes on the CPU or with
``use_kernels=False``.  The two-tier spill layout is built and exchanged
as two tiers, so each reaches the kernels as contiguous ``[3, C, K]``
planes.  ``pid`` stays an integer column of every migration payload.

Capacity model (static shapes): each shard holds ``cap`` particle
slots, and at most ``migrate_cap`` particles cross a face a hop a step;
overflow is counted, never silent.  Send-side overflow keeps the
particle alive locally one more step (a delay, not a loss); receive-side
overflow (no free slot for an arriving migrant) loses it and is counted
in ``DistAux.migrate_overflow``.  The step reads nothing back to the
host.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.exchange import Exchange
from ..utils.trace import get_tracer
from . import ops
from .cells import CellGrid, CellList, _sorted_slot_map
from .cells import wrap_axes as _wrap_axes
from .kernels import WendlandC2
from .step import (
    _carried_density,
    _cfl_dt,
    _floor_density,
    _integrate,
    resolve_policy,
    tait_pressure,
)


class DistState(NamedTuple):
    """Per-shard particle slots: each field holds one tensor a shard that
    this process drives (every shard of a one-process mesh), in mesh
    order, on that shard's device.

    ``pid`` keeps a particle's identity across migrations (-1 = dead
    slot).  ``rho`` is the carried density, set in continuity mode only
    (``make_distributed_step_fn(density_mode="continuity")``).
    """

    x: tuple  # [cap, 3] float32 a shard
    v: tuple  # [cap, 3] float32 a shard
    pid: tuple  # [cap] int32 a shard, -1 for dead slots
    rho: tuple = None  # [cap] float32 a shard, or None (summation mode)


class DistAux(NamedTuple):
    """The step's per-shard outputs, one tensor a shard of this process."""

    rho: tuple  # [cap]
    p: tuple  # [cap]
    cell_overflow: tuple  # 0-d int32: particles dropped from the cells
    migrate_overflow: tuple  # 0-d int32: failed migrations
    dudt: tuple  # [cap] internal-energy rate (zeros unless compute_energy)


def _local_cells(x, alive, nxl, ny, nz, capacity, lo_local, cell_size):
    """The cell list of one shard's slab (x-major local ids, one stable
    sort): dead slots sort into a sentinel cell past the grid, whose row
    never holds live slots (``live_rows``).  Returns a
    :class:`~tpgsd_torch.sph.cells.CellList` whose ``gidx``/``mask`` are
    ``[c + 1, capacity]`` and whose ``slot`` is ``capacity`` for dropped
    and dead particles."""
    c = nxl * ny * nz
    idx = torch.floor((x - lo_local) / cell_size).to(torch.int64)
    cid = (torch.clamp(idx[:, 0], 0, nxl - 1) * (ny * nz)
           + torch.clamp(idx[:, 1], 0, ny - 1) * nz
           + torch.clamp(idx[:, 2], 0, nz - 1))
    cid = torch.where(alive, cid, c)  # dead -> sentinel cell
    order, cid_s, valid, gidx, slot, starts = _sorted_slot_map(
        cid, c + 1, capacity, live_rows=c
    )
    dead_s = cid_s == c
    dropped = (slot >= capacity) & ~dead_s
    return CellList(
        order=order,
        cid=cid_s,
        slot=torch.where(dropped | dead_s, capacity, slot),
        gidx=gidx,
        mask=valid,
        overflow=dropped.sum().to(torch.int32),
        starts=starts,
    )


def _scatter(values, cells, c, k, n_tiers):
    """Dense SoA tiers ``[T, F, c, K]`` (a view) of per-particle
    ``values [n, F]``: tier ``t`` holds slots ``tK .. (t+1)K - 1`` of each
    cell, dead slots 0.  One gather of the sorted rows through
    ``cells.gidx``."""
    vs = values[cells.order]
    vs_t = torch.cat([vs, vs.new_zeros((1, vs.shape[1]))]).t().contiguous()
    idx = cells.gidx[:c].reshape(c, n_tiers, k).transpose(0, 1)  # [T, c, K]
    return vs_t[:, idx].transpose(0, 1)


def _rows(mom, rho_p, energy, cells, fill, local_grid, ext_grid,
          plain=False):
    """One shard's particle rows of its core cells' per-slot results
    (:func:`~tpgsd_torch.sph.ops.slot_rows`), a list a tier each:
    ``mom`` the momentum pass's ``[C_ext, K, F]`` (acc | (drho) | (xsph
    dv)), ``rho_p`` the ``(rho, p)`` planes (summation mode, else
    ``None``) and ``energy`` du/dt (or ``None``); dropped and dead
    particles read ``fill``.  The core block of ``local_grid`` lies one
    ghost layer into each extended axis of ``ext_grid``; ``plain`` as
    in :func:`~tpgsd_torch.sph.ops.slot_rows`."""
    tiers = []
    for t, m in enumerate(mom):
        cols = [m] + ([] if rho_p is None else list(rho_p[t]))
        if energy is not None:
            cols.append(energy[t])
        tiers.append(cols)
    offset = tuple((e - b) // 2 for e, b in zip(ext_grid.dims,
                                                local_grid.dims))
    return ops.slot_rows(tiers, fill, cells, local_grid.dims, ext_grid.dims,
                         offset, plain=plain)


def _pack_migrants(values, send_mask, cap):
    """Pack the rows of each of ``values`` (``[n, ...]`` tensors) where
    ``send_mask`` into ``[cap, ...]`` buffers, in row order (the rank is
    a cumsum; no host sync).

    Returns ``(buffers, valid [cap], overflow, sent [n])``: rows past
    ``cap`` are not packed (the caller keeps them alive locally one more
    step) and counted in ``overflow`` (0-d int32)."""
    n = send_mask.shape[0]
    dev = send_mask.device
    rank = torch.cumsum(send_mask, 0) - 1  # pack position
    ok = send_mask & (rank < cap)
    src = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    src[torch.where(ok, rank, cap)] = torch.arange(n, device=dev)
    src = src[:cap]  # row packed at each position, n = empty
    bufs = [torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])[src]
            for v in values]
    overflow = (send_mask.sum() - ok.sum()).to(torch.int32)
    return bufs, src < n, overflow, ok


def _insert(values, alive, recv_vals, recv_valid):
    """Insert received rows into dead slots, first fit.

    The valid rows are ranked by their order among the valid rows, not
    by buffer position, so the j-th arriving migrant takes the j-th free
    slot wherever it landed in the stacked receive buffer.  ``values``
    and ``recv_vals`` are matching lists of tensors.  Returns ``(merged,
    n_lost)``, ``n_lost`` (0-d int32) counting valid rows that found no
    free slot."""
    n = alive.shape[0]
    dev = alive.device
    dead = ~alive
    dead_rank = torch.cumsum(dead, 0) - 1  # rank among dead slots
    # slot of the k-th dead slot (row n collects the live slots' writes)
    slot_of_rank = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(dead, dead_rank, n)] = torch.arange(n, device=dev)
    recv_rank = torch.cumsum(recv_valid, 0) - 1
    targets = slot_of_rank[torch.clamp(recv_rank, 0, max(n - 1, 0))]
    targets = torch.where(recv_valid, targets, n)  # invalid -> dropped
    lost = (recv_valid & (targets >= n)).sum().to(torch.int32)
    merged = []
    for v, r in zip(values, recv_vals):
        out = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
        out[targets] = r
        merged.append(out[:n])
    return merged, lost


def _block_neighbours(index, shape, axis, ring):
    """``(bwd, fwd)``: the shards before and after the block at
    ``index`` along mesh axis ``axis`` of a mesh of ``shape`` (``None``
    past a non-periodic end; on a ring of 1 both are the block itself)."""
    def at(j):
        if not 0 <= j < shape[axis]:
            if not ring:
                return None
            j %= shape[axis]
        idx = list(index)
        idx[axis] = j
        return int(np.ravel_multi_index(idx, shape))

    return at(index[axis] - 1), at(index[axis] + 1)


def _halo_axis(cores, axis, neighbours, xchg):
    """One axis of the ordered halo: each of ``cores`` (one tensor a
    shard of this process, the cell axes unflattened, ``axis`` the tensor
    axis of the block axis) gains its ``bwd`` neighbour's last layer
    before and its ``fwd`` neighbour's first layer after (zeros past a
    non-periodic end), through ``xchg`` -> the extended tensors."""
    n = cores[0].shape[axis]
    got = xchg([{"bwd": a.narrow(axis, n - 1, 1), "fwd": a.narrow(axis, 0, 1)}
                for a in cores],
               [dict(zip(("bwd", "fwd"), nb)) for nb in neighbours])
    out = []
    for a, g in zip(cores, got):
        ghosts = []
        for key in ("bwd", "fwd"):
            if g[key] is None:
                shape = list(a.shape)
                shape[axis] = 1
                ghosts.append(a.new_zeros(shape))
            else:
                ghosts.append(g[key])
        out.append(torch.cat([ghosts[0], a, ghosts[1]], dim=axis))
    return out


def _block_halo(cores, dims, axes, neighbours, xchg):
    """The ordered halo of ``[..., c, K]`` tensors (one a shard of this
    process, ``c`` the ``dims`` block's cells, x-major) -> the ``[...,
    c_ext, K]`` extended tensors, contiguous.  ``neighbours[i][d]`` is
    shard ``d``'s ``(bwd, fwd)`` along the decomposed grid axis
    ``axes[i]``; the innermost decomposed axis goes first, so each later
    axis carries the earlier ghosts."""
    lead = cores[0].shape[:-2]
    k = cores[0].shape[-1]
    cur = [a.reshape(lead + tuple(dims) + (k,)) for a in cores]
    for i in reversed(range(len(axes))):
        cur = _halo_axis(cur, len(lead) + axes[i], neighbours[i], xchg)
    return [a.reshape(lead + (-1, k)) for a in cur]


def _block_core(a, ext_dims, axes, axis):
    """The block's own cells of ``a``'s extended cell axis ``axis`` (the
    ghost layer cut from each end of the decomposed grid axes
    ``axes``)."""
    axis %= a.dim()
    v = a.reshape(a.shape[:axis] + tuple(ext_dims) + a.shape[axis + 1:])
    for i in axes:
        v = v.narrow(axis + i, 1, ext_dims[i] - 2)
    return v.reshape(a.shape[:axis] + (-1,) + a.shape[axis + 1:])


def _migrate_axis(rows, axis, neighbours, bounds, ring, lo, period, mig_cap,
                  xchg):
    """One migration hop along the decomposed grid ``axis``, over every
    shard of this process (``xchg.local``; ``neighbours`` and ``bounds``
    are indexed by the mesh's shard).

    ``rows[i] = (vals [cap, F] float32, pid [cap] int32, overflow)``, of
    shard ``xchg.local[i]``:
    ``vals`` holds x | v | (rho) with the raw coordinate of every
    decomposed axis.  A row whose coordinate left ``bounds[d] = (lo,
    hi)`` of its block goes to the neighbour that way (not past a
    non-periodic end); the sent copy wraps the hop's own coordinate on a
    ring (``lo + remainder(coord - lo, period)``), a row kept back by
    send-side overflow keeps its raw one.  Every shard packs before any
    inserts, and a shard inserts its ``bwd`` neighbour's migrants before
    its ``fwd`` one's: returns the new ``rows``, each overflow grown by
    the send-side overflow and the receive-side losses."""
    packs = []
    for d, (vals, pid, _ovf) in zip(xchg.local, rows):
        alive = pid >= 0
        coord = vals[:, axis]
        go = [alive & (coord < bounds[d][0]), alive & (coord >= bounds[d][1])]
        go = [g if n is not None else torch.zeros_like(g)
              for g, n in zip(go, neighbours[d])]
        send = vals
        if ring:
            wrapped = lo + torch.remainder(coord - lo, period)
            send = torch.cat([vals[:, :axis], wrapped[:, None],
                              vals[:, axis + 1:]], dim=1)
        bufs, sent, ovf = [], [], 0
        for g in go:
            buf, valid, o, s = _pack_migrants([send, pid], g, mig_cap)
            bufs.append(buf + [valid])
            sent.append(s)
            ovf = ovf + o
        pid_after = torch.where(sent[0] | sent[1], -1, pid)
        alive_after = pid_after >= 0
        keep = torch.where(alive_after[:, None], vals, 0.0)
        packs.append((bufs, (keep, pid_after, alive_after, ovf)))

    # from the bwd neighbour its fwd buffer, from the fwd one its bwd
    got = xchg([{"bwd": bufs[1], "fwd": bufs[0]} for bufs, _keep in packs],
               [dict(zip(("bwd", "fwd"), nb)) for nb in neighbours])
    out = []
    for (_vals, _pid, ovf), (_bufs, kept), g in zip(rows, packs, got):
        keep, keep_pid, alive_after, send_ovf = kept
        recv = [_empty_buffers(keep, keep_pid) if g[key] is None else g[key]
                for key in ("bwd", "fwd")]
        (vals, pid_out), lost = _insert(
            [keep, keep_pid], alive_after,
            [torch.cat([r[0] for r in recv]), torch.cat([r[1] for r in recv])],
            torch.cat([r[2] for r in recv]))
        out.append((vals, pid_out, ovf + send_ovf + lost))
    return out


def concat_shards(tensors):
    """The per-shard tensors of a :class:`DistState` or :class:`DistAux`
    field as one tensor of all slots on the first shard's device (the
    reference's ``[S * cap, ...]`` global array): for ``frame_of`` of a
    dump, e.g. ``lambda s, aux: [concat_shards(s.x),
    concat_shards(aux.rho)]``.  On a mesh over several processes these
    are this process's slots only; hand a writer :func:`frame_shards`
    there."""
    dev = tensors[0].device
    return torch.cat([t.to(dev, non_blocking=True) for t in tensors])


def frame_shards(tensors, mesh):
    """A :class:`DistState` or :class:`DistAux` field of this process as
    the writers' :class:`~tpgsd_torch.parallel.ProcessShards`: shard
    ``d``'s slots are rows ``d * cap ..`` of the ``[S * cap, ...]`` global
    array that :func:`concat_shards` makes in one process, so a file
    written by every process from its own shards is byte-equal to the
    one process's."""
    from ..parallel.shard_io import ProcessShards

    cap = int(tensors[0].shape[0])
    return ProcessShards(
        starts=tuple(d * cap for d in mesh.local), tensors=tuple(tensors),
        shape=(mesh.size * cap,) + tuple(tensors[0].shape[1:]))


def _per_device(devices, local, make):
    """``make(device)`` once per distinct device of the ``local`` shards,
    as a list a shard of the mesh (``None`` for other processes')."""
    made = {}
    for d in local:
        if devices[d] not in made:
            made[devices[d]] = make(devices[d])
    return [made.get(dev) if d in local else None
            for d, dev in enumerate(devices)]


def make_distributed_step_fn(
    grid,
    params,
    mesh,
    capacity=None,
    migrate_cap=None,
    kernel=WendlandC2,
    use_kernels="auto",
    n_fixed=0,
    periodic=False,
    compute_energy=False,
    decomp_axis=0,
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    spill="auto",
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the slab-decomposed step over ``mesh``.

    Args:
        grid: global :class:`~tpgsd_torch.sph.cells.CellGrid`;
            ``grid.dims[decomp_axis]`` must be a multiple of the mesh
            size (each shard owns that many planes of cells).
        params: :class:`~tpgsd_torch.sph.SPHParams`.
        mesh: a 1-D :class:`~tpgsd_torch.parallel.Mesh`; the states the
            step takes lie on its devices, shard ``d`` on
            ``mesh.devices[d]``.
        capacity: particle slots a shard (required;
            :func:`distribute_state` returns its choice).
        migrate_cap: migrations a face a step (default ``capacity // 4``,
            at least 8).
        use_kernels / spill: as in :func:`tpgsd_torch.sph.make_step_fn`,
            resolved by :func:`~tpgsd_torch.sph.step.resolve_policy` for
            the mesh's device type on a slab's extended grid: on CUDA
            ``"auto"`` runs the kernels, the two-tier spill layout up to
            64 slots a cell and the single tier past it; elsewhere the
            plain pair passes (``spill=True`` runs the plain spill ops).
        n_fixed: particles with ``pid < n_fixed`` (the first rows of the
            state given to :func:`distribute_state`) are static boundary
            particles: density and pressure sources that never move and
            never migrate.
        periodic: periodic box.  The slab axis wraps through the ring of
            shards (shard S-1 exchanges planes and migrants with shard 0,
            whose ghost positions are shifted by the box length); the
            other two axes wrap locally, as the pair passes' own ghost
            halo (the kernels) or wrapped neighbour table (the plain
            passes), on axes with at least 3 cells.
        compute_energy: also run the WCSPH energy equation on the
            exchanged density and pressure and return du/dt in
            ``aux.dudt`` (zeros when off).
        decomp_axis: 0 (x-slabs) or 1 (y-slabs).
        xsph / density_renorm / surface_tension / density_mode /
            delta_sph / kernel: as in :func:`tpgsd_torch.sph.make_step_fn`.
            The density floor and renormalisation act on the owners'
            densities before their exchange; surface tension exchanges
            the owners' normals of the boundary planes before its force
            pass.  In continuity mode the density is carried state
            (``DistState.rho``; seed the global state with
            :func:`tpgsd_torch.sph.init_density` before
            :func:`distribute_state`), so one fused exchange of
            x | v | rho | live replaces summation's two, and migrants
            carry their density.  The velocity kick applies
            ``params.velocity_damping``, as the global step does.

    Returns:
        ``step(state, dt=params.dt) -> (DistState, DistAux)``, carrying
        ``resolved = {"use_kernels", "spill", "density_mode"}``.  ``dt``
        may be a 0-d float32 device tensor.  The step makes no host sync.
        With the tracer enabled (:func:`tpgsd_torch.utils.get_tracer`)
        it opens the range ``mesh.step`` and, nested in it, one range a
        stage over every shard: ``mesh.cells`` (cell build and dense
        tiers), ``mesh.halo`` (the exchange of the boundary layers),
        ``mesh.density`` (the density pass and, in summation mode, the
        exchange of the owners' density and pressure), ``mesh.momentum``
        (the momentum pass, the options, the rows to particles, a
        ``mesh.rows`` range a shard, and the integration) and
        ``mesh.migrate`` (packing, exchanging and inserting the
        migrants); every decomposition opens the same ranges.  Each step
        counts one in :data:`~tpgsd_torch.parallel.exchange.stats`
        (``steps``).  (With the private ``_traced_dt=True`` it returns
        ``(state, aux, a2max)``, ``a2max`` one 0-d tensor a shard: the
        largest ``|a|^2`` of its mobile particles, for
        :func:`make_adaptive_distributed_step_fn`.)
    """
    if decomp_axis not in (0, 1):
        raise ValueError("decomp_axis must be 0 or 1, got %r" % (decomp_axis,))
    n = grid.dims[decomp_axis]
    if n % mesh.size != 0:
        raise ValueError(
            "grid n%s=%d must be a multiple of the mesh size %d"
            % ("xy"[decomp_axis], n, mesh.size)
        )
    return _decomposed_step(
        grid, params, mesh, (decomp_axis,), capacity=capacity,
        migrate_cap=migrate_cap, kernel=kernel, use_kernels=use_kernels,
        n_fixed=n_fixed, periodic=periodic, compute_energy=compute_energy,
        xsph=xsph, density_renorm=density_renorm,
        surface_tension=surface_tension, spill=spill,
        density_mode=density_mode, delta_sph=delta_sph,
        _traced_dt=_traced_dt,
    )


def _names(n_dec):
    """The builder and the partitioner of a decomposition of ``n_dec``
    axes, for the errors."""
    if n_dec == 1:
        return "make_distributed_step_fn", "distribute_state"
    return ("make_distributed%dd_step_fn" % n_dec,
            "distribute_state_%dd" % n_dec)


def _axis_names(axes):
    """``"y"``, ``"x and y"``, ``"x, y and z"``: grid axes, for the
    errors."""
    names = ["xyz"[a] for a in axes]
    return " and ".join(filter(None, [", ".join(names[:-1]), names[-1]]))


def _decomposed_step(grid, params, mesh, axes, capacity=None,
                     migrate_cap=None, kernel=WendlandC2, use_kernels="auto",
                     n_fixed=0, periodic=False, compute_energy=False,
                     xsph=0.0, density_renorm=False, surface_tension=0.0,
                     spill="auto", density_mode="summation", delta_sph=0.1,
                     _traced_dt=False):
    """The staged step of every decomposition: ``mesh`` cuts the grid
    axes ``axes`` (increasing: ``(0,)`` x-slabs, ``(1,)`` y-slabs, ``(0,
    1)`` the 2-D and ``(0, 1, 2)`` the 3-D blocks) into
    ``mesh.shape[i]`` blocks along ``axes[i]``.  Arguments, ranges and
    result as :func:`make_distributed_step_fn`'s."""
    n_dec = len(axes)
    builder, distribute = _names(n_dec)
    shape = tuple(mesh.shape)
    if len(shape) != n_dec:
        raise ValueError("%s needs a %d-D mesh, got shape %r"
                         % (builder, n_dec, shape))
    dims = tuple(grid.dims)
    if any(dims[a] % s for a, s in zip(axes, shape)):
        raise ValueError(
            "grid dims %s must be multiples of the mesh shape %s"
            % (tuple(dims[a] for a in axes), shape))
    if capacity is None:
        raise ValueError("pass capacity (slots a shard; %s returns it)"
                         % distribute)
    continuity = _check_options(xsph, surface_tension, density_mode,
                                density_renorm)
    periodic = bool(periodic)
    if periodic and min(dims[a] for a in axes) < 3:
        raise ValueError("periodic needs >= 3 cells along %s"
                         % _axis_names(axes))
    devices = tuple(mesh.devices)
    _check_device_type(devices)
    xchg = Exchange(mesh)
    local = xchg.local
    phase = get_tracer().range
    n_sh = len(devices)
    cap = int(capacity)
    mig_cap = int(migrate_cap) if migrate_cap is not None else max(8, cap // 4)
    k = grid.capacity
    cell = grid.cell_size

    parts = [shape[axes.index(a)] if a in axes else 1 for a in range(3)]
    bdims = tuple(n // p for n, p in zip(dims, parts))
    edims = tuple(b + 2 if a in axes else b for a, b in enumerate(bdims))
    c = int(np.prod(bdims))
    # the extended (ghost-padded) grid of a block, on which the pair
    # passes run; only its core cells' outputs are used
    ext_grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=cell, dims=edims,
                        capacity=k)
    local_grid = ext_grid._replace(dims=bdims)
    use_kernels, spill = resolve_policy(devices[0].type, ext_grid,
                                        use_kernels, spill)
    resolved = {"use_kernels": use_kernels, "spill": spill,
                "density_mode": density_mode}
    n_tiers = 2 if spill else 1
    kd = n_tiers * k  # retained slots a cell
    wrap = _wrap_axes(grid, periodic)
    rings = [periodic and bool(wrap[a]) for a in axes]
    # the decomposed axes wrap through the rings; only the others reach
    # the pair passes
    pair_wrap = tuple(periodic and bool(wrap[a]) and a not in axes
                      for a in range(3))
    passes = _pair_passes(ext_grid, params, kernel, use_kernels, spill,
                          continuity, delta_sph, xsph > 0, surface_tension,
                          pair_wrap if any(pair_wrap) else None)

    index = [np.unravel_index(d, shape) for d in range(n_sh)]
    neighbours = [[_block_neighbours(index[d], shape, i, rings[i])
                   for d in range(n_sh)] for i in range(n_dec)]

    # host constants of each shard, in float32 as the reference forms
    # them, made on its device now (no host-to-device copy in the step)
    lo_np = np.asarray(grid.lo, np.float32)
    hi_np = lo_np + cell * np.asarray(grid.dims, np.float32)
    offs = np.zeros((n_sh, 3), np.float32)
    for d in range(n_sh):
        for i, a in enumerate(axes):
            offs[d, a] = (np.float32(index[d][i] * bdims[a])
                          * np.float32(cell))
    bounds = [[(float(lo_np[a] + offs[d, a]),
                float(np.float32(lo_np[a] + offs[d, a])
                      + np.float32(bdims[a] * cell)))
               for d in range(n_sh)] for a in axes]
    period = [float(np.float32(cell * dims[a])) for a in range(3)]
    lo_local = [torch.from_numpy(lo_np + offs[d]).to(devices[d])
                if d in local else None for d in range(n_sh)]
    lo = _per_device(devices, local, lambda d: torch.from_numpy(lo_np).to(d))
    hi = _per_device(devices, local, lambda d: torch.from_numpy(hi_np).to(d))
    gravity = _per_device(devices, local, lambda d: torch.from_numpy(
        np.asarray(params.gravity, np.float32)).to(d))
    wrapped = _per_device(devices, local,
                          lambda d: torch.from_numpy(wrap).to(d))
    fill = _fill(params, continuity, xsph, compute_energy)

    def halo(cores):
        return _block_halo(cores, bdims, axes, neighbours, xchg)

    def core(a, axis=-2):
        return _block_core(a, edims, axes, axis)

    def shift_seams(ext):
        """On a ring, the ghost layers across the seam arrived with raw
        coordinates: shift them by -+L (the whole layer, the corner
        columns received from the other axes included)."""
        for d, e in zip(local, ext):
            v = e.view(e.shape[:2] + edims + (e.shape[-1],))
            for i, a in enumerate(axes):
                if not rings[i]:
                    continue
                if index[d][i] == 0:
                    v.narrow(2 + a, 0, 1)[:, a] -= period[a]
                if index[d][i] == shape[i] - 1:
                    v.narrow(2 + a, edims[a] - 1, 1)[:, a] += period[a]

    def body(state, dt):
        _check_state(state, [devices[d] for d in local], cap, continuity,
                     distribute)
        # every per-shard list below runs over this process's shards:
        # entry i is shard local[i]
        xs, vs, pids = state.x, state.v, state.pid
        alive = [p >= 0 for p in pids]
        dts = [dt.to(devices[d], non_blocking=True)
               if isinstance(dt, torch.Tensor) else dt for d in local]

        # stage 1: the local cells and dense tiers [T, F, c, K] of every
        # shard (x | v | (rho) | live)
        with phase("mesh.cells"):
            cells, dense = [], []
            for i, d in enumerate(local):
                cl = _local_cells(xs[i], alive[i], *bdims, kd, lo_local[d],
                                  cell)
                cols = [xs[i], vs[i]]
                if continuity:
                    cols.append(state.rho[i][:, None])
                cols.append(xs[i].new_ones((cap, 1)))
                cells.append(cl)
                dense.append(_scatter(torch.cat(cols, dim=1), cl, c, k,
                                      n_tiers))

        # stage 2: the ordered halo, then the seam shifts
        with phase("mesh.halo"):
            ext = halo(dense)
            del dense
            if any(rings):
                shift_seams(ext)
            tiers = [[(e[0:3], e[3:6], e[6] if continuity else None,
                       e[-1] > 0.5) for e in et] for et in ext]

        # stage 3: density and pressure of every slot of the extended grid
        with phase("mesh.density"):
            if continuity:
                # carried state: ghost densities are exact as exchanged
                rho_p = [[_floor_density(t[2], t[3], params) for t in tt]
                         for tt in tiers]
            else:
                # only core outputs are right (a ghost cell's neighbourhood
                # reaches past the halo): the owners' floored density and
                # pressure replace the ghosts'
                rp_core = []
                for tt in tiers:
                    rho_t = passes.density(tt)
                    rp_core.append(torch.stack([
                        torch.stack(_floor_density(core(r), core(t[3]),
                                                   params, density_renorm))
                        for r, t in zip(rho_t, tt)
                    ]))  # [T, 2, c, K]
                rp_ext = halo(rp_core)
                del rp_core
                rho_p = [
                    [(torch.where(t[3], rp[0], params.rho0),
                      torch.where(t[3], rp[1], 0.0)) for t, rp in zip(tt, rpe)]
                    for tt, rpe in zip(tiers, rp_ext)
                ]
            fields = [[(t[0], t[1], r, p, t[3]) for t, (r, p) in zip(tt, rp)]
                      for tt, rp in zip(tiers, rho_p)]

        # stage 4: the momentum pass (acc | (drho) | (xsph dv)) [C, K, F]
        with phase("mesh.momentum"):
            mom = [passes.momentum(f) for f in fields]
            if surface_tension > 0:
                # as density, a ghost's normals are the owner's
                n_core = [torch.stack([core(n) for n in passes.normals(f)])
                          for f in fields]  # [T, 3, c, K]
                n_ext = halo(n_core)
                del n_core
                for i, f in enumerate(fields):
                    ns = [torch.where(t[4], n, 0.0)
                          for t, n in zip(f, n_ext[i])]
                    for m, st in zip(mom[i], passes.force(f, ns)):
                        m[..., :3] += st
            energy = ([passes.energy(f) for f in fields] if compute_energy
                      else None)

            # ... the core cells' results to particle rows, and the
            # integration
            new, a2 = [], []
            for i, d in enumerate(local):
                with phase("mesh.rows"):
                    out = _rows(mom[i], None if continuity else rho_p[i],
                                energy[i] if compute_energy else None,
                                cells[i], fill, local_grid, ext_grid,
                                not use_kernels)
                new.append(integrate(d, out, xs[i], vs[i], pids[i], alive[i],
                                     state.rho[i] if continuity else None,
                                     dts[i], a2))
            del mom, fields, tiers, ext, rho_p

        # stage 5: one migration hop a decomposed axis, in axis order
        with phase("mesh.migrate"):
            rows = [(vals, pid, 0) for vals, pid, _aux in new]
            for i, a in enumerate(axes):
                rows = _migrate_axis(rows, a, neighbours[i], bounds[i],
                                     rings[i], float(lo_np[a]), period[a],
                                     mig_cap, xchg)
            out_x = tuple(vals[:, 0:3].contiguous() for vals, _, _ in rows)
            out_v = tuple(vals[:, 3:6].contiguous() for vals, _, _ in rows)
            out_pid = tuple(pid for _, pid, _ in rows)
            if continuity:
                # a migrant's density arrived in its payload: state and
                # aux stay aligned with the slots they describe
                out_rho = tuple(torch.where(pid >= 0, vals[:, 6], params.rho0)
                                for vals, pid, _ in rows)
                aux_rho = out_rho
                aux_p = tuple(torch.where(pid >= 0, tait_pressure(r, params),
                                          0.0)
                              for r, pid in zip(out_rho, out_pid))
            else:
                aux_rho = tuple(nd[2][0] for nd in new)
                aux_p = tuple(nd[2][1] for nd in new)

        new_state = DistState(x=out_x, v=out_v, pid=out_pid,
                              rho=out_rho if continuity else None)
        aux = DistAux(
            rho=aux_rho, p=aux_p,
            cell_overflow=tuple(cl.overflow for cl in cells),
            migrate_overflow=tuple(ovf for _, _, ovf in rows),
            dudt=tuple(nd[2][2] for nd in new),
        )
        xchg.count_step()
        if _traced_dt:
            return new_state, aux, tuple(a2)
        return new_state, aux

    @torch.inference_mode()
    def step(state, dt=params.dt):
        with phase("mesh.step"):
            return body(state, dt)

    def integrate(d, out, x, v, pid, alive, rho_in, dt, a2):
        """The gathered rows ``out`` of shard ``d`` -> ``(vals, pid,
        (rho_aux, p_aux, dudt))``: ``vals`` x | v | (rho) after the
        global step's integration, the coordinates raw on the decomposed
        axes (the hops detect a crossing on them, and wrap them on a
        ring) and wrapped on the locally wrapped ones."""
        x_new, v_new, x_raw, rho, _alive, rho_aux, p_aux, dudt = (
            _integrate_rows(out, x, v, pid, alive, rho_in, dt, params,
                            gravity[d], lo[d], hi[d],
                            wrapped[d] if periodic else None, continuity,
                            xsph, compute_energy, n_fixed,
                            a2 if _traced_dt else None))
        cols = [(x_raw if a in axes else x_new)[:, a:a + 1] for a in range(3)]
        extra = [rho[:, None]] if continuity else []
        return (torch.cat(cols + [v_new] + extra, dim=1), pid,
                (rho_aux, p_aux, dudt))

    step.resolved = resolved
    return step


def _check_options(xsph, surface_tension, density_mode, density_renorm):
    """The option guards of every decomposition; returns whether the
    density mode is continuity."""
    if xsph < 0 or surface_tension < 0:
        raise ValueError(
            "xsph and surface_tension must be >= 0; got %r and %r"
            % (xsph, surface_tension)
        )
    continuity = density_mode == "continuity"
    if density_mode not in ("summation", "continuity"):
        raise ValueError("unknown density_mode: %r" % (density_mode,))
    if continuity and density_renorm:
        raise ValueError(
            "density_renorm corrects the summation-density free-surface "
            "deficit; continuity mode has no deficit to correct - use "
            "delta_sph for its noise control instead"
        )
    return continuity


def _check_device_type(devices):
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError("a mesh of one device type; got %s" % sorted(kinds))


def _check_state(state, devices, cap, continuity, distribute):
    """A state for a step built for ``cap`` slots on each of ``devices``
    (``distribute`` names the function that makes one, for the error)."""
    if len(state.x) != len(devices):
        raise ValueError(
            "step built for %d shards got a state of %d"
            % (len(devices), len(state.x))
        )
    for d, (x, dev) in enumerate(zip(state.x, devices)):
        if x.device != dev or tuple(x.shape) != (cap, 3):
            raise ValueError(
                "shard %d: step built for [%d, 3] on %s got %s on %s"
                % (d, cap, dev, tuple(x.shape), x.device)
            )
    if continuity and state.rho is None:
        raise ValueError(
            "density_mode='continuity' needs DistState.rho - seed the "
            "global state with tpgsd_torch.sph.init_density before "
            "%s" % distribute
        )


def _fill(params, continuity, xsph, compute_energy):
    """The row of dropped and dead particles (:func:`_rows`): zero acc,
    drho, dvc, p and du; rho0."""
    n_out = (3 + int(continuity) + 3 * int(xsph > 0)
             + 2 * int(not continuity) + int(compute_energy))
    fill = [0.0] * n_out
    if not continuity:
        fill[3 + 3 * int(xsph > 0)] = float(params.rho0)
    return tuple(fill)


def _integrate_rows(out, x, v, pid, alive, rho_in, dt, params, gravity, lo,
                    hi, wrapped, continuity, xsph, compute_energy, n_fixed,
                    a2):
    """One shard's gathered rows ``out`` -> ``(x_new, v_new, x_raw, rho,
    alive, rho_aux, p_aux, dudt)``: the global step's integration (``rho``
    the carried density in continuity mode, ``rho_aux``/``p_aux`` the
    summed ones otherwise), ``x_raw`` the coordinates before the wrap of
    the ``wrapped`` axes, for the crossing test of a seam.  With a list
    ``a2`` it appends the mobile particles' largest ``|a|^2``."""
    acc = out[:, :3] + gravity
    col = 3
    if continuity:
        drho = out[:, 3]
        col = 4
    drift_dv = None
    if xsph > 0:
        drift_dv = xsph * out[:, col:col + 3]
        col += 3
    if continuity:
        rho_c, _ = _carried_density(rho_in, drho, dt, params)
        rho = torch.where(alive, rho_c, params.rho0)
        rho_aux = p_aux = None
    else:
        rho = None
        rho_aux, p_aux = out[:, col], out[:, col + 1]
        col += 2
    dudt = out[:, col] if compute_energy else torch.zeros_like(out[:, 0])
    x_new, v_new, x_raw = _integrate(x, v, acc, dt, params, lo, hi, drift_dv,
                                     wrapped, raw=True)
    still = ~alive  # dead slots do not move
    if n_fixed > 0:
        # boundary particles: sources that never move or migrate
        fixed = alive & (pid < n_fixed)
        still = still | fixed
        v_new = torch.where(fixed[:, None], 0.0, v_new)
    x_new = torch.where(still[:, None], x, x_new)
    x_raw = torch.where(still[:, None], x, x_raw)
    v_new = torch.where(alive[:, None], v_new, v)
    if a2 is not None:
        # the controller's force input: the mobile particles' |a|^2
        mobile = alive & (pid >= n_fixed) if n_fixed > 0 else alive
        a2.append(torch.amax(torch.where(
            mobile, torch.sum(acc * acc, dim=-1), 0.0)))
    return x_new, v_new, x_raw, rho, alive, rho_aux, p_aux, dudt


def _empty_buffers(keep, keep_pid):
    """The receive buffers past a non-periodic end: no valid row."""
    return [keep.new_zeros((0, keep.shape[1])), keep_pid.new_zeros(0),
            torch.zeros(0, dtype=torch.bool, device=keep.device)]


class _Passes(NamedTuple):
    """The pair passes of one shard's extended grid, each over a list of
    tiers (one, or the two spill tiers) and returning one tensor a tier:
    ``density(tiers) -> [C, K]``, ``momentum(fields) -> [C, K, F]``
    (acc | (drho) | (xsph dv)), ``energy(fields) -> [C, K]``,
    ``normals(fields) -> [3, C, K]`` and ``force(fields, normals) -> [C,
    K, 3]``; a tier is ``(x, v, rho, live)``, its fields ``(x, v, rho, p,
    live)``."""

    density: object
    momentum: object
    energy: object
    normals: object
    force: object


def _pair_passes(grid, params, kernel, use_kernels, spill, continuity,
                 delta_sph, xsph, gamma, wrap):
    """:class:`_Passes` on ``grid`` over :func:`~tpgsd_torch.sph.ops.
    pair_ops`: the kernels (the ghost halo for ``wrap``) with
    ``use_kernels``, the plain passes otherwise (the wrapped table and
    minimum image)."""
    kw = {"kernel": kernel, "wrap_axes": wrap}
    mom_kw = dict(kw, xsph=xsph)
    if continuity:
        mom_kw["delta_sph"] = delta_sph
    sel = ops.pair_ops(use_kernels, spill, continuity)

    if spill:
        return _Passes(
            density=lambda t: list(sel.density(
                t[0][0], t[0][3], t[1][0], t[1][3], grid, params, **kw)),
            momentum=lambda f: list(sel.momentum(*f[0], *f[1], grid, params,
                                                 **mom_kw)),
            energy=lambda f: list(sel.energy(*f[0], *f[1], grid, params,
                                             **kw)),
            normals=lambda f: list(sel.normals(
                f[0][0], f[0][2], f[0][4], f[1][0], f[1][2], f[1][4], grid,
                params, **kw)),
            force=lambda f, n: list(sel.force(
                f[0][0], n[0], f[0][2], f[0][4], f[1][0], n[1], f[1][2],
                f[1][4], grid, params, gamma, **kw)),
        )
    return _Passes(
        density=lambda t: [sel.density(t[0][0], t[0][3], grid, params, **kw)],
        momentum=lambda f: [sel.momentum(*f[0], grid, params, **mom_kw)
                            .permute(1, 2, 0)],
        energy=lambda f: [sel.energy(*f[0], grid, params, **kw)],
        normals=lambda f: [sel.normals(f[0][0], f[0][2], f[0][4], grid,
                                       params, **kw)],
        force=lambda f, n: [sel.force(f[0][0], n[0], f[0][2], f[0][4], grid,
                                      params, gamma, **kw).permute(1, 2, 0)],
    )


def make_adaptive_distributed_step_fn(grid, params, mesh, cfl=0.25,
                                      dt_min=0.0, dt_max=None, **kwargs):
    """CFL-adaptive variant of the decomposed step: the controller of
    :func:`tpgsd_torch.sph.make_adaptive_step_fn`, computed globally.
    Each shard reports its mobile particles' largest ``|a|^2`` and its
    slots' largest ``|v|^2`` (dead and fixed slots carry ``v = 0``); the
    maxima meet on the first shard's device of each process (across
    processes in one ``all_reduce`` MAX), where ``dt_next`` is made, the
    same on every process, and every shard steps with the same ``dt``.
    No host sync with one process (Gloo stages the maxima through the
    host: one sync a step).

    Args:
        grid / params / mesh: as :func:`make_distributed_step_fn`.
        cfl / dt_min / dt_max: as the single-device adaptive builder
            (``dt_max`` defaults to ``params.dt``).
        **kwargs: forwarded to :func:`make_distributed_step_fn`.

    Returns:
        ``step(state, dt) -> (DistState, DistAux, dt_next)``, ``dt`` and
        ``dt_next`` 0-d float32 tensors; roll it out with
        :func:`tpgsd_torch.sph.run_adaptive`.  At ``dt == params.dt`` it
        steps bit for bit as the fixed step.
    """
    return _adaptive_step(
        make_distributed_step_fn(grid, params, mesh, _traced_dt=True,
                                 **kwargs),
        params, mesh, cfl, dt_min, dt_max)


def _adaptive_step(base, params, mesh, cfl, dt_min, dt_max):
    """The CFL controller around ``base`` (a decomposed step built with
    ``_traced_dt=True``): the shards' maxima meet
    (:meth:`~tpgsd_torch.parallel.exchange.Exchange.allreduce_max`) on
    this process's first shard's device, where ``dt_next`` is made.
    Shared by every decomposition."""
    if dt_max is None:
        dt_max = float(params.dt)
    xchg = Exchange(mesh)

    @torch.inference_mode()
    def step(state, dt):
        new_state, aux, a2 = base(state, dt)
        a2max, v2max = xchg.allreduce_max(
            [torch.stack([a, torch.amax(torch.sum(v * v, dim=-1))])
             for a, v in zip(a2, new_state.v)])
        return new_state, aux, _cfl_dt(a2max, v2max, params, cfl, dt_min,
                                       dt_max)

    step.resolved = base.resolved
    return step


def _host(a):
    """A numpy view of a host array or a copy of a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def distribute_state(state, grid, mesh, capacity=None, decomp_axis=0):
    """Partition a global state onto the mesh by slab ownership.

    ``state`` is an :class:`~tpgsd_torch.sph.SPHState` (tensors or numpy;
    ``rho`` set for continuity mode).  Each shard's slots hold the
    particles inside its slab, in original-index ``pid`` order, on its
    device; the other slots are dead (``pid = -1``, zeros).

    Args:
        capacity: slots a shard (default: the smallest multiple of 8 at
            least twice the largest slab population).
        decomp_axis: the slab axis, matching the step builder's.

    Returns:
        ``(DistState, capacity)``.  On a mesh over several processes,
        every process passes the whole state (as the reference's workers
        hold it) and gets its own shards.
    """
    return _distribute(state, grid, mesh, (decomp_axis,), capacity)


def _distribute(state, grid, mesh, axes, capacity):
    """Place each particle of ``state`` on the shard whose block (of the
    engine's cut of the grid axes ``axes``) holds it, in original-index
    ``pid`` order, the other slots dead, and put this process's shards on
    their devices; ``capacity`` defaults to the smallest multiple of 8 at
    least twice the largest shard population -> ``(DistState,
    capacity)``.  Shared by every decomposition."""
    shape = tuple(mesh.shape)
    if len(shape) != len(axes):
        raise ValueError("%s needs a %d-D mesh, got shape %r"
                         % (_names(len(axes))[1], len(axes), shape))
    devices = mesh.devices
    n_sh = len(devices)
    x = _host(state.x).astype(np.float32, copy=False)
    v = _host(state.v).astype(np.float32, copy=False)
    rho = None if state.rho is None else _host(state.rho)
    block = []
    for a, s in zip(axes, shape):
        width = grid.dims[a] // s * grid.cell_size
        block.append(np.clip(((x[:, a] - grid.lo[a]) // width).astype(
            np.int64), 0, s - 1))
    owner = np.ravel_multi_index(block, shape)
    pops = np.bincount(owner, minlength=n_sh)
    if capacity is None:
        capacity = int(-(-2 * max(int(pops.max()), 1) // 8) * 8)

    xs = np.zeros((n_sh, capacity, 3), np.float32)
    vs = np.zeros((n_sh, capacity, 3), np.float32)
    pids = np.full((n_sh, capacity), -1, np.int32)
    rhos = None if rho is None else np.zeros((n_sh, capacity), np.float32)
    for d in range(n_sh):
        sel = np.nonzero(owner == d)[0]
        if len(sel) > capacity:
            raise ValueError(
                "shard %d %s holds %d particles > capacity %d"
                % (d, "slab" if len(axes) == 1 else "block", len(sel),
                   capacity)
            )
        xs[d, : len(sel)] = x[sel]
        vs[d, : len(sel)] = v[sel]
        pids[d, : len(sel)] = sel
        if rhos is not None:
            rhos[d, : len(sel)] = rho[sel]

    def put(a):
        return tuple(torch.from_numpy(a[d]).to(devices[d])
                     for d in mesh.local)

    return DistState(
        x=put(xs), v=put(vs), pid=put(pids),
        rho=None if rhos is None else put(rhos),
    ), capacity


class CollectedState(NamedTuple):
    """Host gather of a :class:`DistState`, in original ``pid`` order;
    ``rho`` is ``None`` unless the state carried continuity density."""

    x: "np.ndarray"  # [n_global, 3]
    v: "np.ndarray"  # [n_global, 3]
    rho: "np.ndarray" = None  # [n_global] or None


def _slots(per_shard, comm):
    """The slots of every shard of this process, or with ``comm``, of
    every process's (rank order)."""
    mine = np.concatenate([_host(t) for t in per_shard])
    if comm is None or comm.size == 1:
        return mine
    return np.concatenate(comm.allgather(mine))


def collect_state(dist_state, n_global, comm=None):
    """Gather a :class:`DistState` to the host in original ``pid``
    order -> :class:`CollectedState` of numpy arrays (reads the
    device).  On a mesh over several processes pass its ``comm``: every
    process then gets the whole collection (the reference's
    ``process_allgather(..., tiled=True)``); without it, only this
    process's particles are set."""
    pid = _slots(dist_state.pid, comm)
    alive = pid >= 0
    out_x = np.zeros((n_global, 3), np.float32)
    out_v = np.zeros((n_global, 3), np.float32)
    out_x[pid[alive]] = _slots(dist_state.x, comm)[alive]
    out_v[pid[alive]] = _slots(dist_state.v, comm)[alive]
    if dist_state.rho is None:
        return CollectedState(x=out_x, v=out_v, rho=None)
    out_rho = np.zeros(n_global, np.float32)
    out_rho[pid[alive]] = _slots(dist_state.rho, comm)[alive]
    return CollectedState(x=out_x, v=out_v, rho=out_rho)


def collect_aux(dist_state, aux, n_global, params=None, comm=None):
    """Gather a :class:`DistAux`'s per-slot fields to host ``pid`` order:
    numpy ``(rho, p, dudt)``, each ``[n_global]`` (``dudt`` zeros unless
    the step computed the energy).  Absent particles hold ``rho0`` (with
    ``params``, else 0) and 0.  ``comm`` as :func:`collect_state`'s.

    ``dist_state`` is the state whose slots the fields describe: in
    summation mode the state the step took (its rows are computed before
    the migrants move), in continuity mode the state it returned."""
    pid = _slots(dist_state.pid, comm)
    alive = pid >= 0
    rho0 = float(params.rho0) if params is not None else 0.0
    out_rho = np.full(n_global, rho0, np.float32)
    out_p = np.zeros(n_global, np.float32)
    out_du = np.zeros(n_global, np.float32)
    out_rho[pid[alive]] = _slots(aux.rho, comm)[alive]
    out_p[pid[alive]] = _slots(aux.p, comm)[alive]
    out_du[pid[alive]] = _slots(aux.dudt, comm)[alive]
    return out_rho, out_p, out_du
