"""Slab domain decomposition of the SPH step over a device mesh, with
halo exchange and particle migration (torch counterpart of
``tpgsd.sph.distributed``).

The domain is cut into contiguous x-slabs, one a shard of a 1-D
:class:`~tpgsd_torch.parallel.Mesh` (the linear cell index is x-major,
so a slab is a contiguous cell range).  Each shard owns the particles in
its slab, in ``cap`` slots with a ``pid`` (-1 for a dead slot), and a
step communicates only

* one cell plane of boundary data to each x-neighbour, and
* the particles that crossed a slab face (migration buffers of at most
  ``migrate_cap`` rows a face).

No global sort and no gather of the whole state.

The reference runs one body on every device at once (``shard_map``) and
exchanges with ``lax.ppermute``, a collective.  Here each process drives
its shards of the mesh (every shard, with one process; its own, with one
process per rank: ``make_mesh(comm=...)``) from a Python loop, and the
exchanges go through :class:`~tpgsd_torch.parallel.exchange.Exchange`: a
copy of a neighbour's planes to the receiving shard's device (a no-op
view when both shards share a device, as they do on a one-GPU machine)
between two shards of one process, a message between processes.  So the
step runs in stages, each over every shard before the next reads a
neighbour's output: (1) the local cell build and the dense tiers, (2) the
halo exchange, (3) the density pass and the exchange of the owners'
density and pressure (summation mode), (4) the momentum pass (with the
options) and the integration, (5) packing the migrants, (6) their
exchange and insertion.  Every stage makes new tensors and none writes
its inputs, so no shard reads a neighbour's new state where the
reference reads the old one.  The ends of a non-periodic mesh receive
zero planes, as ``ppermute`` gives to unnamed targets; the zeroed live
mask makes them empty ghosts.  A periodic mesh is a ring.

Each shard lays its particles out on the extended grid of its slab (its
``nxl`` planes and one ghost plane each side) and runs the unchanged
pair passes of :mod:`tpgsd_torch.sph.ops` there: the CUDA kernels when
its tensors are on the card, the plain passes on the CPU or with
``use_kernels=False``.  The two-tier spill layout is built and exchanged
as two tiers, so each reaches the kernels as contiguous ``[3, C, K]``
planes.

Capacity model (static shapes): each shard holds ``cap`` particle
slots, and at most ``migrate_cap`` particles cross a face a step;
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
from .cells import CellGrid, CellList, _sorted_slot_map, gather_from_cells
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


def _gather(dense, cells, local_grid, capacity, sentinel):
    """Per-particle rows of the per-slot ``dense [c, capacity, F]``
    (dropped and dead particles read the ``sentinel [F]`` row), through
    the sort's inverse permutation
    (:func:`~tpgsd_torch.sph.cells.gather_from_cells`)."""
    sent = sentinel.expand(1, capacity, sentinel.shape[0])
    return gather_from_cells(torch.cat([dense, sent]), cells, local_grid,
                             capacity=capacity)


def _neighbours(d, n_shards, ring):
    """``(left, right)`` shard of shard ``d`` (``None`` past a
    non-periodic end)."""
    left = d - 1 if d > 0 else (n_shards - 1 if ring else None)
    right = d + 1 if d < n_shards - 1 else (0 if ring else None)
    return left, right


def _halo_exchange(cores, nynz, ring, xchg):
    """Append each x-neighbour's boundary cell plane as ghost planes.

    ``cores``: one ``[..., c, K]`` tensor a shard of this process (cell
    axis -2).  Returns the extended ``[..., nynz + c + nynz, K]`` tensors,
    contiguous.  The left ghost of shard ``d`` is the last plane of shard
    ``d - 1``, its right ghost the first plane of shard ``d + 1`` (through
    ``xchg``, an :class:`~tpgsd_torch.parallel.exchange.Exchange`); past a
    non-periodic end the ghost is zeros, on a ring the far end's plane."""
    c = cores[0].shape[-2]
    got = xchg([{"L": a[..., c - nynz:c, :], "R": a[..., 0:nynz, :]}
                for a in cores],
               [dict(zip("LR", _neighbours(d, xchg.size, ring)))
                for d in range(xchg.size)])
    out = []
    for a, g in zip(cores, got):
        ghosts = [a.new_zeros(a.shape[:-2] + (nynz, a.shape[-1]))
                  if g[key] is None else g[key] for key in "LR"]
        out.append(torch.cat([ghosts[0], a, ghosts[1]], dim=-2))
    return out


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


#: column permutation swapping the x and y axes of ``[N, 3]`` arrays
_PERM01 = (1, 0, 2)


def _swap01_tuple(t):
    return (t[1], t[0], t[2])


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
    _ranged=True,
):
    """Build the slab-decomposed step over ``mesh``.

    Args:
        grid: global :class:`~tpgsd_torch.sph.cells.CellGrid`;
            ``grid.dims[decomp_axis]`` must be a multiple of the mesh
            size (each shard owns that many planes of cells).
        params: :class:`~tpgsd_torch.sph.SPHParams`.
        mesh: :class:`~tpgsd_torch.parallel.Mesh`; the states the step
            takes lie on its devices, shard ``d`` on ``mesh.devices[d]``.
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
        periodic: periodic box.  x wraps through the ring of shards
            (shard S-1 exchanges planes and migrants with shard 0, whose
            ghost positions are shifted by the box length); y and z wrap
            locally, as the pair passes' own ghost halo (the kernels) or
            wrapped neighbour table (the plain passes), on axes with at
            least 3 cells.
        compute_energy: also run the WCSPH energy equation on the
            exchanged density and pressure and return du/dt in
            ``aux.dudt`` (zeros when off).
        decomp_axis: 0 (x-slabs) or 1 (y-slabs: the x machinery on the
            axis-swapped problem).
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
            carry their density.

    Returns:
        ``step(state, dt=params.dt) -> (DistState, DistAux)``, carrying
        ``resolved = {"use_kernels", "spill", "density_mode"}``.  ``dt``
        may be a 0-d float32 device tensor.  The step makes no host sync.
        With the tracer enabled (:func:`tpgsd_torch.utils.get_tracer`)
        it opens the range ``mesh.step`` and, nested in it, one range a
        stage over every shard: ``mesh.cells`` (cell build and dense
        tiers), ``mesh.halo`` (the exchange of the boundary planes),
        ``mesh.density`` (the density pass and, in summation mode, the
        exchange of the owners' density and pressure), ``mesh.momentum``
        (the momentum pass, the options, the gather and integration) and
        ``mesh.migrate`` (packing, exchanging and inserting the migrants);
        with ``decomp_axis=1`` ``mesh.step`` holds the axis swaps too.
        Each step counts one in :data:`~tpgsd_torch.parallel.exchange.
        stats` (``steps``).  (With the private ``_traced_dt=True`` it
        returns ``(state, aux, a2max)``, ``a2max`` one 0-d tensor a
        shard: the largest ``|a|^2`` of its mobile particles, for
        :func:`make_adaptive_distributed_step_fn`.)
    """
    if decomp_axis == 1:
        return _swapped_step(
            grid, params, mesh, capacity=capacity, migrate_cap=migrate_cap,
            kernel=kernel, use_kernels=use_kernels, n_fixed=n_fixed,
            periodic=periodic, compute_energy=compute_energy, xsph=xsph,
            density_renorm=density_renorm, surface_tension=surface_tension,
            spill=spill, density_mode=density_mode, delta_sph=delta_sph,
            _traced_dt=_traced_dt,
        )
    if decomp_axis != 0:
        raise ValueError("decomp_axis must be 0 or 1, got %r" % (decomp_axis,))
    continuity = _check_options(xsph, surface_tension, density_mode,
                                density_renorm)

    devices = tuple(mesh.devices)
    n_sh = len(devices)
    nx, ny, nz = grid.dims
    if nx % n_sh != 0:
        raise ValueError(
            "grid nx=%d must be a multiple of the mesh size %d" % (nx, n_sh)
        )
    if capacity is None:
        raise ValueError(
            "pass capacity (slots a shard; distribute_state returns it)"
        )
    if periodic and nx < 3:
        raise ValueError("periodic needs >= 3 cells along x")
    _check_device_type(devices)
    xchg = Exchange(mesh)
    local = xchg.local
    phase = get_tracer().range
    nxl = nx // n_sh
    nynz = ny * nz
    c = nxl * nynz
    cap = int(capacity)
    mig_cap = int(migrate_cap) if migrate_cap is not None else max(8, cap // 4)
    k = grid.capacity
    cell = grid.cell_size

    # the extended (ghost-padded) grid of a slab, on which the pair
    # passes run; only its core planes' outputs are used
    ext_grid = CellGrid(
        lo=(0.0, 0.0, 0.0), cell_size=cell, dims=(nxl + 2, ny, nz), capacity=k
    )
    local_grid = ext_grid._replace(dims=(nxl, ny, nz))
    use_kernels, spill = resolve_policy(devices[0].type, ext_grid,
                                        use_kernels, spill)
    resolved = {"use_kernels": use_kernels, "spill": spill,
                "density_mode": density_mode}
    n_tiers = 2 if spill else 1
    kd = n_tiers * k  # retained slots a cell
    core = slice(nynz, nynz + c)
    periodic = bool(periodic)
    wrap = _wrap_axes(grid, periodic)
    # x wraps through the ring; only the local y/z wraps reach the passes
    pair_wrap = (False, bool(wrap[1]), bool(wrap[2]))
    pair_wrap = pair_wrap if periodic and any(pair_wrap) else None
    passes = _pair_passes(ext_grid, params, kernel, use_kernels, spill,
                          continuity, delta_sph, xsph > 0, surface_tension,
                          pair_wrap)

    # host constants of each shard, in float32 as the reference forms
    # them, made on its device now (no host-to-device copy in the step)
    lo_np = np.asarray(grid.lo, np.float32)
    hi_np = lo_np + cell * np.asarray(grid.dims, np.float32)
    offs = [np.float32(np.float32(d * nxl) * np.float32(cell))
            for d in range(n_sh)]
    slab_lo = [float(lo_np[0] + off) for off in offs]
    slab_hi = [float(np.float32(lo) + np.float32(nxl * cell))
               for lo in slab_lo]
    lx = float(np.float32(cell * nx))
    lo_local = [
        torch.from_numpy(lo_np + np.asarray([off, 0.0, 0.0], np.float32)).to(
            devices[d]) if d in local else None
        for d, off in enumerate(offs)
    ]
    lo = _per_device(devices, local, lambda d: torch.from_numpy(lo_np).to(d))
    hi = _per_device(devices, local, lambda d: torch.from_numpy(hi_np).to(d))
    gravity = _per_device(devices, local, lambda d: torch.from_numpy(
        np.asarray(params.gravity, np.float32)).to(d))
    wrapped = _per_device(devices, local,
                          lambda d: torch.from_numpy(wrap).to(d))
    sentinel = _sentinels(devices, local, params, continuity, xsph,
                          compute_energy)

    def tiers_of(ext):
        """Per tier ``(x, v, rho or None, live)`` of one shard's extended
        ``[T, F, C_ext, K]`` layout; every plane contiguous."""
        return [(e[0:3], e[3:6], e[6] if continuity else None, e[-1] > 0.5)
                for e in ext]

    def body(state, dt):
        _check_state(state, [devices[d] for d in local], cap, continuity,
                     "distribute_state")
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
                cl = _local_cells(xs[i], alive[i], nxl, ny, nz, kd,
                                  lo_local[d], cell)
                cols = [xs[i], vs[i]]
                if continuity:
                    cols.append(state.rho[i][:, None])
                cols.append(xs[i].new_ones((cap, 1)))
                cells.append(cl)
                dense.append(_scatter(torch.cat(cols, dim=1), cl, c, k,
                                      n_tiers))

        # stage 2: one plane of cells each way; on the ring the far end's
        # planes arrive with raw coordinates, shifted by -+Lx here so
        # every ghost position is geometrically true
        with phase("mesh.halo"):
            ext = _halo_exchange(dense, nynz, periodic, xchg)
            del dense
            if periodic:
                if local[0] == 0:
                    ext[0][:, 0, :nynz] -= lx
                if local[-1] == n_sh - 1:
                    ext[-1][:, 0, nynz + c:] += lx
            tiers = [tiers_of(e) for e in ext]

        # stage 3: density and pressure of every slot of the extended grid
        with phase("mesh.density"):
            if continuity:
                # carried state: ghost densities are exact as exchanged
                rho_p = [[_floor_density(t[2], t[3], params) for t in tt]
                         for tt in tiers]
            else:
                # only core outputs are right (a ghost cell's neighbourhood
                # reaches past the halo): the owners' floored density and
                # pressure of the boundary planes replace the ghosts'
                rp_core = []
                for tt in tiers:
                    rho_t = passes.density(tt)
                    rp_core.append(torch.stack([
                        torch.stack(_floor_density(r[core], t[3][core], params,
                                                   density_renorm))
                        for r, t in zip(rho_t, tt)
                    ]))  # [T, 2, c, K]
                rp_ext = _halo_exchange(rp_core, nynz, periodic, xchg)
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
                n_core = [torch.stack([n[:, core] for n in passes.normals(f)])
                          for f in fields]  # [T, 3, c, K]
                n_ext = _halo_exchange(n_core, nynz, periodic, xchg)
                del n_core
                for i, f in enumerate(fields):
                    ns = [torch.where(t[4], n, 0.0)
                          for t, n in zip(f, n_ext[i])]
                    for m, st in zip(mom[i], passes.force(f, ns)):
                        m[..., :3] += st
            energy = ([passes.energy(f) for f in fields] if compute_energy
                      else None)

            # ... the core planes' results as one particle-order gather, and
            # the integration
            new, a2 = [], []
            for i, d in enumerate(local):
                cols = []
                for t in range(n_tiers):
                    col = [mom[i][t][core]]
                    if not continuity:
                        col += [rho_p[i][t][0][core, :, None],
                                rho_p[i][t][1][core, :, None]]
                    if compute_energy:
                        col.append(energy[i][t][core, :, None])
                    cols.append(torch.cat(col, dim=-1))
                out = _gather(torch.cat(cols, dim=1), cells[i], local_grid, kd,
                              sentinel[d])
                new.append(integrate(d, out, xs[i], vs[i], pids[i], alive[i],
                                     state.rho[i] if continuity else None,
                                     dts[i], a2))
            del mom, fields, tiers, ext, rho_p

        # stage 5: pack the migrants of every shard
        with phase("mesh.migrate"):
            packs = [migrants(d, pids[i], *new[i][:5])
                     for i, d in enumerate(local)]

            # stage 6: exchange (a shard receives its left neighbour's
            # right-going buffers and its right neighbour's left-going ones)
            # and insert
            got = xchg([{"L": pk["right"], "R": pk["left"]} for pk in packs],
                       [dict(zip("LR", _neighbours(d, n_sh, periodic)))
                        for d in range(n_sh)])
            out_x, out_v, out_pid, out_rho, out_p, migrate_ovf = ([] for _ in
                                                                   range(6))
            for pk, g in zip(packs, got):
                keep, keep_pid, alive_after, send_ovf = pk["keep"]
                recv = [_empty_buffers(keep, keep_pid) if g[key] is None
                        else g[key] for key in "LR"]
                recv_vals = torch.cat([recv[0][0], recv[1][0]])
                recv_pid = torch.cat([recv[0][1], recv[1][1]])
                recv_valid = torch.cat([recv[0][2], recv[1][2]])
                (vals, pid_out), lost = _insert([keep, keep_pid], alive_after,
                                                [recv_vals, recv_pid],
                                                recv_valid)
                out_x.append(vals[:, 0:3].contiguous())
                out_v.append(vals[:, 3:6].contiguous())
                out_pid.append(pid_out)
                live = pid_out >= 0
                if continuity:
                    # a migrant's density arrived in its payload: state and
                    # aux stay aligned with the slots they describe
                    rho = torch.where(live, vals[:, 6], params.rho0)
                    out_rho.append(rho)
                    out_p.append(torch.where(live, tait_pressure(rho, params),
                                             0.0))
                migrate_ovf.append(send_ovf + lost)

        if continuity:
            aux_rho, aux_p = out_rho, out_p
        else:
            aux_rho = [nd[5] for nd in new]
            aux_p = [nd[6] for nd in new]
        new_state = DistState(
            x=tuple(out_x), v=tuple(out_v), pid=tuple(out_pid),
            rho=tuple(out_rho) if continuity else None,
        )
        aux = DistAux(
            rho=tuple(aux_rho), p=tuple(aux_p),
            cell_overflow=tuple(cl.overflow for cl in cells),
            migrate_overflow=tuple(migrate_ovf),
            dudt=tuple(nd[7] for nd in new),
        )
        xchg.count_step()
        if _traced_dt:
            return new_state, aux, tuple(a2)
        return new_state, aux

    @torch.inference_mode()
    def step(state, dt=params.dt):
        if not _ranged:  # the axis-swapped step opens the range itself
            return body(state, dt)
        with phase("mesh.step"):
            return body(state, dt)

    def integrate(d, out, x, v, pid, alive, rho_in, dt, a2):
        return _integrate_rows(
            out, x, v, pid, alive, rho_in, dt, params, gravity[d], lo[d],
            hi[d], wrapped[d] if periodic else None, continuity, xsph,
            compute_energy, n_fixed, a2 if _traced_dt else None)

    def migrants(d, pid, x_new, v_new, x_raw, rho, alive):
        """Stage 5 of shard ``d``: the particles that left its slab
        (detected on the unwrapped x), packed right and left, and the
        rows it keeps."""
        go_left = alive & (x_raw[:, 0] < slab_lo[d])
        go_right = alive & (x_raw[:, 0] >= slab_hi[d])
        if not periodic:
            if d == 0:
                go_left = torch.zeros_like(go_left)
            if d == n_sh - 1:
                go_right = torch.zeros_like(go_right)
        # the payload carries the wrapped x (right on the receiving
        # slab); a particle kept back by send-side overflow keeps its raw
        # x and re-detects the crossing next step, while the local y/z
        # wraps always commit
        extra = [rho[:, None]] if continuity else []
        payload = torch.cat([x_new, v_new] + extra, dim=1)
        buf_r, valid_r, ovf_r, sent_r = _pack_migrants([payload, pid],
                                                       go_right, mig_cap)
        buf_l, valid_l, ovf_l, sent_l = _pack_migrants([payload, pid],
                                                       go_left, mig_cap)
        pid_after = torch.where(sent_r | sent_l, -1, pid)
        alive_after = pid_after >= 0
        x_keep = torch.cat([x_raw[:, 0:1], x_new[:, 1:3]], dim=1)
        keep = torch.cat([x_keep, v_new] + extra, dim=1)
        keep = torch.where(alive_after[:, None], keep, 0.0)
        return {
            "right": buf_r + [valid_r],
            "left": buf_l + [valid_l],
            "keep": (keep, pid_after, alive_after, ovf_r + ovf_l),
        }

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


def _sentinels(devices, local, params, continuity, xsph, compute_energy):
    """The gathered row of dropped and dead particles, one a shard of the
    mesh (``None`` past this process's ``local`` shards): zero acc, drho,
    dvc, p and du; rho0."""
    n_out = (3 + int(continuity) + 3 * int(xsph > 0)
             + 2 * int(not continuity) + int(compute_energy))

    def sentinel_of(dev):
        s = torch.zeros(n_out, dtype=torch.float32, device=dev)
        if not continuity:
            s[3 + 3 * int(xsph > 0)] = params.rho0
        return s

    return _per_device(devices, local, sentinel_of)


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


def _swapped_step(grid, params, mesh, _traced_dt=False, **kw):
    """``decomp_axis=1``: the x machinery on the axis-swapped problem
    (SPH is isotropic, so swapping the x and y of the grid, gravity and
    state is exact), one column permutation a shard each way."""
    inner = make_distributed_step_fn(
        grid._replace(lo=_swap01_tuple(grid.lo),
                      dims=_swap01_tuple(grid.dims)),
        params._replace(gravity=_swap01_tuple(tuple(params.gravity))),
        mesh, decomp_axis=0, _traced_dt=_traced_dt, _ranged=False, **kw,
    )
    phase = get_tracer().range
    local = mesh.local
    perm = _per_device(tuple(mesh.devices), local, lambda d: torch.tensor(
        _PERM01, dtype=torch.int64, device=d))
    perm = [perm[d] for d in local]

    def swapped(state):
        # rho is a scalar field: unchanged by the swap
        return state._replace(
            x=tuple(t.index_select(1, p) for t, p in zip(state.x, perm)),
            v=tuple(t.index_select(1, p) for t, p in zip(state.v, perm)),
        )

    def step(state, dt=params.dt):
        # |acc| is invariant under the swap: a2max passes straight through
        with phase("mesh.step"):
            out = inner(swapped(state), dt)
            return (swapped(out[0]),) + tuple(out[1:])

    step.resolved = inner.resolved
    return step


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
    n_sh = mesh.size
    nxl = grid.dims[decomp_axis] // n_sh
    x = _host(state.x).astype(np.float32, copy=False)
    slab_width = nxl * grid.cell_size
    owner = np.clip(
        ((x[:, decomp_axis] - grid.lo[decomp_axis]) // slab_width).astype(
            np.int64
        ),
        0,
        n_sh - 1,
    )
    return _partition(state._replace(x=x), owner, mesh, capacity, "slab")


def _partition(state, owner, mesh, capacity, unit):
    """Place each particle of ``state`` on the shard ``owner`` names (an
    ``[N]`` numpy array), in original-index ``pid`` order, the other
    slots dead, and put this process's shards on their devices;
    ``capacity`` defaults to the smallest multiple of 8 at least twice the
    largest shard population -> ``(DistState, capacity)``.  Shared by
    every decomposition (``unit`` names a shard's region in the error)."""
    devices = mesh.devices
    n_sh = len(devices)
    x = _host(state.x).astype(np.float32, copy=False)
    v = _host(state.v).astype(np.float32, copy=False)
    rho = None if state.rho is None else _host(state.rho)
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
                % (d, unit, len(sel), capacity)
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
