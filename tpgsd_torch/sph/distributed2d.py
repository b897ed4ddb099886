"""2-D block decomposition of the SPH step over a ``(px, py)`` mesh, and
the block engine that the 3-D decomposition shares (torch counterpart of
``tpgsd.sph.distributed2d``).

Shard ``(i, j)`` of a :func:`~tpgsd_torch.parallel.make_mesh2d` mesh
(shard ``i * py + j``) owns the ``nxl x nyl x nz`` cell block at block
coordinates ``(i, j)``; the 3-D form (:mod:`tpgsd_torch.sph.
distributed3d`) cuts z too.  A step communicates only

* one cell layer of boundary data across each block face, exchanged one
  decomposed axis at a time, innermost first (2-D: y, then x of the
  y-extended block; 3-D: z, y, x), so the edge and corner cells ride
  along with the faces exchanged later, and
* the particles that left their block, in one hop a decomposed axis
  (x, then y, then z): a particle received on the x hop takes part in
  the y hop of the same step, so a diagonal (corner) mover arrives in
  one step.

As the slab form (:mod:`tpgsd_torch.sph.distributed`), each process
drives its shards of the mesh (every shard, or with one process per
rank its own) and the exchanges go through
:class:`~tpgsd_torch.parallel.exchange.Exchange` (a copy to the
receiving shard's device within a process, a message between
processes), so the step runs in stages, each over every shard before
the next reads a neighbour's output: the local cells, each halo axis, the
density and its owners' exchange, the momentum pass (with the owners'
surface-tension normals exchanged before the force pass), the
integration, and each migration hop.  The ends of a non-periodic axis
receive zeros (empty ghosts); a periodic axis is a ring (of 1 or 2
shards too, which exchange with themselves or with their one neighbour
both ways), and after the whole halo the ghost layers across a seam are
shifted by the box length, the corner columns received from another
axis included.  In 2-D, z wraps locally, in the pair passes' own ghost
halo (the kernels) or wrapped table (the plain passes); in 3-D no axis
wraps locally.

Each shard runs the slab form's pair passes on its block's extended grid
(``(nxl + 2, nyl + 2, nz)``; 3-D ``(nxl + 2, nyl + 2, nzl + 2)``): the
CUDA kernels on the card, the plain passes on the CPU or with
``use_kernels=False``.  ``pid`` stays an integer column of every
migration payload.  Capacities are static and overflow is counted, as
in the slab form.
"""

import numpy as np
import torch

from ..parallel.exchange import Exchange
from .cells import CellGrid
from .cells import wrap_axes as _wrap_axes
from .distributed import (
    DistAux,
    DistState,
    _adaptive_step,
    _check_device_type,
    _check_options,
    _check_state,
    _empty_buffers,
    _gather,
    _host,
    _insert,
    _integrate_rows,
    _local_cells,
    _pack_migrants,
    _pair_passes,
    _partition,
    _per_device,
    _scatter,
    _sentinels,
)
from .kernels import WendlandC2
from .step import _floor_density, resolve_policy, tait_pressure


def _block_neighbours(index, shape, axis, ring):
    """``(bwd, fwd)``: the shards before and after the block at
    ``index`` along ``axis`` of a mesh of ``shape`` (``None`` past a
    non-periodic end; on a ring of 1 both are the block itself)."""
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


def _block_halo(cores, dims, neighbours, xchg):
    """The ordered halo of ``[..., c, K]`` tensors (one a shard of this
    process, ``c`` the ``dims`` block's cells, x-major) -> the ``[...,
    c_ext, K]`` extended tensors, contiguous.  ``neighbours[a][d]`` is
    shard ``d``'s ``(bwd, fwd)`` along decomposed axis ``a``; the
    innermost decomposed axis goes first, so each later axis carries the
    earlier ghosts."""
    lead = cores[0].shape[:-2]
    k = cores[0].shape[-1]
    cur = [a.reshape(lead + tuple(dims) + (k,)) for a in cores]
    for axis in reversed(range(len(neighbours))):
        cur = _halo_axis(cur, len(lead) + axis, neighbours[axis], xchg)
    return [a.reshape(lead + (-1, k)) for a in cur]


def _block_core(a, ext_dims, n_dec, axis):
    """The block's own cells of ``a``'s extended cell axis ``axis`` (the
    ghost layer cut from each end of the ``n_dec`` decomposed axes)."""
    axis %= a.dim()
    v = a.reshape(a.shape[:axis] + tuple(ext_dims) + a.shape[axis + 1:])
    for i in range(n_dec):
        v = v.narrow(axis + i, 1, ext_dims[i] - 2)
    return v.reshape(a.shape[:axis] + (-1,) + a.shape[axis + 1:])


def _migrate_axis(rows, axis, neighbours, bounds, ring, lo, period, mig_cap,
                  xchg):
    """One migration hop along decomposed ``axis``, over every shard of
    this process (``xchg.local``; ``neighbours`` and ``bounds`` are
    indexed by the mesh's shard).

    ``rows[i] = (vals [cap, F] float32, pid [cap] int32, overflow)``, of
    shard ``xchg.local[i]``:
    ``vals`` holds x | v | (rho) with the raw coordinate of every
    decomposed axis.  A row whose coordinate left ``bounds[d] = (lo,
    hi)`` of its block goes to the neighbour that way (not past a
    non-periodic end); the sent copy wraps the hop's own coordinate on a
    ring (``lo + remainder(coord - lo, period)``), a row kept back by
    send-side overflow keeps its raw one.  Every shard packs before any
    inserts: returns the new ``rows``, each overflow grown by the
    send-side overflow and the receive-side losses."""
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


def _make_block_step(grid, params, mesh, n_decomposed, name, capacity=None,
                     migrate_cap=None, kernel=WendlandC2, use_kernels="auto",
                     n_fixed=0, periodic=False, compute_energy=False,
                     xsph=0.0, density_renorm=False, surface_tension=0.0,
                     spill="auto", density_mode="summation", delta_sph=0.1,
                     _traced_dt=False):
    """The block-decomposed step over the first ``n_decomposed`` axes
    (2 or 3), for :func:`make_distributed2d_step_fn` and
    :func:`~tpgsd_torch.sph.distributed3d.make_distributed3d_step_fn`
    (``name`` is the builder's, for its errors)."""
    n_dec = n_decomposed
    shape = tuple(mesh.shape)
    if len(shape) != n_dec:
        raise ValueError("%s needs a %d-D mesh, got shape %r"
                         % (name, n_dec, shape))
    dims = tuple(grid.dims)
    if any(dims[a] % shape[a] for a in range(n_dec)):
        raise ValueError(
            "grid dims %s must be multiples of the mesh shape %s"
            % (dims[:n_dec], shape))
    if capacity is None:
        raise ValueError("pass capacity (slots a shard; distribute_state_%dd "
                         "returns it)" % n_dec)
    continuity = _check_options(xsph, surface_tension, density_mode,
                                density_renorm)
    periodic = bool(periodic)
    if periodic and min(dims[:n_dec]) < 3:
        raise ValueError("periodic needs >= 3 cells along %s"
                         % {2: "x and y", 3: "x, y and z"}[n_dec])
    devices = tuple(mesh.devices)
    _check_device_type(devices)
    xchg = Exchange(mesh)
    local = xchg.local
    n_sh = len(devices)
    cap = int(capacity)
    mig_cap = int(migrate_cap) if migrate_cap is not None else max(8, cap // 4)
    k = grid.capacity
    cell = grid.cell_size

    bdims = tuple(dims[a] // shape[a] if a < n_dec else dims[a]
                  for a in range(3))
    edims = tuple(b + 2 if a < n_dec else b for a, b in enumerate(bdims))
    c = int(np.prod(bdims))
    ext_grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=cell, dims=edims,
                        capacity=k)
    local_grid = ext_grid._replace(dims=bdims)
    use_kernels, spill = resolve_policy(devices[0].type, ext_grid,
                                        use_kernels, spill)
    resolved = {"use_kernels": use_kernels, "spill": spill,
                "density_mode": density_mode}
    n_tiers = 2 if spill else 1
    kd = n_tiers * k
    wrap = _wrap_axes(grid, periodic)
    rings = [periodic and bool(wrap[a]) for a in range(n_dec)]
    # the decomposed axes wrap through the rings; only the others reach
    # the pair passes
    pair_wrap = tuple(periodic and bool(wrap[a]) and a >= n_dec
                      for a in range(3))
    passes = _pair_passes(ext_grid, params, kernel, use_kernels, spill,
                          continuity, delta_sph, xsph > 0, surface_tension,
                          pair_wrap if any(pair_wrap) else None)

    index = [np.unravel_index(d, shape) for d in range(n_sh)]
    neighbours = [[_block_neighbours(index[d], shape, a, rings[a])
                   for d in range(n_sh)] for a in range(n_dec)]

    # host constants of each shard, in float32 as the reference forms
    # them, made on its device now (no host-to-device copy in the step)
    lo_np = np.asarray(grid.lo, np.float32)
    hi_np = lo_np + cell * np.asarray(grid.dims, np.float32)
    offs = [np.asarray([np.float32(np.float32(index[d][a] * bdims[a])
                                   * np.float32(cell)) if a < n_dec else 0.0
                        for a in range(3)], np.float32) for d in range(n_sh)]
    bounds = [[(float(lo_np[a] + offs[d][a]),
                float(np.float32(lo_np[a] + offs[d][a])
                      + np.float32(bdims[a] * cell)))
               for d in range(n_sh)] for a in range(n_dec)]
    period = [float(np.float32(cell * dims[a])) for a in range(3)]
    lo_local = [torch.from_numpy(lo_np + offs[d]).to(devices[d])
                if d in local else None for d in range(n_sh)]
    lo = _per_device(devices, local, lambda d: torch.from_numpy(lo_np).to(d))
    hi = _per_device(devices, local, lambda d: torch.from_numpy(hi_np).to(d))
    gravity = _per_device(devices, local, lambda d: torch.from_numpy(
        np.asarray(params.gravity, np.float32)).to(d))
    wrapped = _per_device(devices, local,
                          lambda d: torch.from_numpy(wrap).to(d))
    sentinel = _sentinels(devices, local, params, continuity, xsph,
                          compute_energy)

    def halo(cores):
        return _block_halo(cores, bdims, neighbours, xchg)

    def core(a, axis=-2):
        return _block_core(a, edims, n_dec, axis)

    def shift_seams(ext):
        """On a ring, the ghost layers across the seam arrived with raw
        coordinates: shift them by -+L (the whole layer, the corner
        columns received from the other axes included)."""
        for d, e in zip(local, ext):
            v = e.view(e.shape[:2] + edims + (e.shape[-1],))
            for a in range(n_dec):
                if not rings[a]:
                    continue
                if index[d][a] == 0:
                    v.narrow(2 + a, 0, 1)[:, a] -= period[a]
                if index[d][a] == shape[a] - 1:
                    v.narrow(2 + a, edims[a] - 1, 1)[:, a] += period[a]

    @torch.inference_mode()
    def step(state, dt=params.dt):
        _check_state(state, [devices[d] for d in local], cap, continuity,
                     "distribute_state_%dd" % n_dec)
        # every per-shard list below runs over this process's shards:
        # entry i is shard local[i]
        xs, vs, pids = state.x, state.v, state.pid
        alive = [p >= 0 for p in pids]
        dts = [dt.to(devices[d], non_blocking=True)
               if isinstance(dt, torch.Tensor) else dt for d in local]

        # stage 1: the local cells and dense tiers [T, F, c, K] of every
        # shard (x | v | (rho) | live)
        cells, dense = [], []
        for i, d in enumerate(local):
            cl = _local_cells(xs[i], alive[i], *bdims, kd, lo_local[d], cell)
            cols = [xs[i], vs[i]]
            if continuity:
                cols.append(state.rho[i][:, None])
            cols.append(xs[i].new_ones((cap, 1)))
            cells.append(cl)
            dense.append(_scatter(torch.cat(cols, dim=1), cl, c, k, n_tiers))

        # stages 2 and 3: the ordered halo, then the seam shifts
        ext = halo(dense)
        del dense
        if any(rings):
            shift_seams(ext)
        tiers = [[(e[0:3], e[3:6], e[6] if continuity else None, e[-1] > 0.5)
                  for e in et] for et in ext]

        # stage 4: density and pressure of every slot of the extended grid
        if continuity:
            rho_p = [[_floor_density(t[2], t[3], params) for t in tt]
                     for tt in tiers]
        else:
            # only core outputs are right: the owners' floored density
            # and pressure replace the ghosts'
            rp_core = []
            for tt in tiers:
                rho_t = passes.density(tt)
                rp_core.append(torch.stack([
                    torch.stack(_floor_density(core(r), core(t[3]), params,
                                               density_renorm))
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

        # stage 5: the momentum pass (acc | (drho) | (xsph dv)) [C, K, F]
        mom = [passes.momentum(f) for f in fields]
        if surface_tension > 0:
            # as density, a ghost's normals are the owner's
            n_core = [torch.stack([core(n) for n in passes.normals(f)])
                      for f in fields]  # [T, 3, c, K]
            n_ext = halo(n_core)
            del n_core
            for i, f in enumerate(fields):
                ns = [torch.where(t[4], n, 0.0) for t, n in zip(f, n_ext[i])]
                for m, st in zip(mom[i], passes.force(f, ns)):
                    m[..., :3] += st
        energy = ([passes.energy(f) for f in fields] if compute_energy
                  else None)

        # stage 6: the core cells' results as one particle-order gather,
        # and the integration
        new, a2 = [], []
        for i, d in enumerate(local):
            cols = []
            for t in range(n_tiers):
                col = [mom[i][t]]
                if not continuity:
                    col += [rho_p[i][t][0][..., None],
                            rho_p[i][t][1][..., None]]
                if compute_energy:
                    col.append(energy[i][t][..., None])
                cols.append(torch.cat(col, dim=-1))
            out = _gather(core(torch.cat(cols, dim=1), 0), cells[i],
                          local_grid, kd, sentinel[d])
            new.append(integrate(d, out, xs[i], vs[i], pids[i], alive[i],
                                 state.rho[i] if continuity else None,
                                 dts[i], a2))
        del mom, fields, tiers, ext, rho_p

        # stage 7: one migration hop a decomposed axis, x first
        rows = [(vals, pid, 0) for vals, pid, _aux in new]
        for a in range(n_dec):
            rows = _migrate_axis(rows, a, neighbours[a], bounds[a], rings[a],
                                 float(lo_np[a]), period[a], mig_cap, xchg)

        out_x = tuple(vals[:, 0:3].contiguous() for vals, _, _ in rows)
        out_v = tuple(vals[:, 3:6].contiguous() for vals, _, _ in rows)
        out_pid = tuple(pid for _, pid, _ in rows)
        if continuity:
            # a migrant's density arrived in its payload: state and aux
            # stay aligned with the slots they describe
            out_rho = tuple(torch.where(pid >= 0, vals[:, 6], params.rho0)
                            for vals, pid, _ in rows)
            aux_rho = out_rho
            aux_p = tuple(torch.where(pid >= 0, tait_pressure(r, params), 0.0)
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

    def integrate(d, out, x, v, pid, alive, rho_in, dt, a2):
        """The gathered rows ``out`` of shard ``d`` -> ``(vals, pid,
        (rho_aux, p_aux, dudt))``: ``vals`` x | v | (rho) after the
        global step's integration, the coordinates raw on the ring axes
        (the hops wrap them) and wrapped on the locally wrapped one."""
        x_new, v_new, x_raw, rho, _alive, rho_aux, p_aux, dudt = (
            _integrate_rows(out, x, v, pid, alive, rho_in, dt, params,
                            gravity[d], lo[d], hi[d],
                            wrapped[d] if periodic else None, continuity,
                            xsph, compute_energy, n_fixed,
                            a2 if _traced_dt else None))
        x_new = torch.cat([x_raw[:, :n_dec], x_new[:, n_dec:]], dim=1)
        extra = [rho[:, None]] if continuity else []
        return (torch.cat([x_new, v_new] + extra, dim=1), pid,
                (rho_aux, p_aux, dudt))

    step.resolved = resolved
    return step


def make_distributed2d_step_fn(
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
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    spill="auto",
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the 2-D block-decomposed step over a ``(px, py)`` mesh.

    Args:
        grid: global :class:`~tpgsd_torch.sph.cells.CellGrid`;
            ``grid.dims[0]`` must be a multiple of ``px`` and
            ``grid.dims[1]`` of ``py``.
        params: :class:`~tpgsd_torch.sph.SPHParams`.
        mesh: a 2-D :class:`~tpgsd_torch.parallel.Mesh`
            (:func:`~tpgsd_torch.parallel.make_mesh2d`); the states the
            step takes lie on its devices, shard ``i * py + j`` (block
            ``(i, j)``) on ``mesh.devices[i * py + j]``.
        capacity: particle slots a shard (required;
            :func:`distribute_state_2d` returns its choice).
        migrate_cap: migrations a face a hop a step (default
            ``capacity // 4``, at least 8).
        use_kernels / spill: as in
            :func:`~tpgsd_torch.sph.distributed.make_distributed_step_fn`,
            resolved on a block's extended grid ``(nxl + 2, nyl + 2,
            nz)``: on CUDA ``"auto"`` runs the kernels, the two-tier spill
            layout up to 64 slots a cell and the single tier past it.
        n_fixed: particles with ``pid < n_fixed`` are static boundary
            particles that never move or migrate.
        periodic: periodic box.  x and y wrap through the rings of the
            mesh's axes (each needs at least 3 cells), z locally in the
            pair passes' ghost halo (the kernels) or wrapped table (the
            plain passes), on at least 3 cells.
        compute_energy / xsph / density_renorm / surface_tension /
            density_mode / delta_sph / kernel: as in the slab step.  The
            velocity kick applies ``params.velocity_damping``, as the
            global step does.

    Returns:
        ``step(state, dt=params.dt) -> (DistState, DistAux)``, carrying
        ``resolved = {"use_kernels", "spill", "density_mode"}``; ``dt``
        may be a 0-d float32 device tensor.  The step makes no host
        sync.
    """
    return _make_block_step(
        grid, params, mesh, 2, "make_distributed2d_step_fn",
        capacity=capacity, migrate_cap=migrate_cap, kernel=kernel,
        use_kernels=use_kernels, n_fixed=n_fixed, periodic=periodic,
        compute_energy=compute_energy, xsph=xsph,
        density_renorm=density_renorm, surface_tension=surface_tension,
        spill=spill, density_mode=density_mode, delta_sph=delta_sph,
        _traced_dt=_traced_dt,
    )


def make_adaptive_distributed2d_step_fn(grid, params, mesh, cfl=0.25,
                                        dt_min=0.0, dt_max=None, **kwargs):
    """CFL-adaptive variant of :func:`make_distributed2d_step_fn`: the
    controller of :func:`~tpgsd_torch.sph.distributed.
    make_adaptive_distributed_step_fn` over the blocks (the maxima meet
    on each process's first shard's device and across processes; no host
    sync with one process).

    Returns:
        ``step(state, dt) -> (DistState, DistAux, dt_next)``; at ``dt ==
        params.dt`` it steps bit for bit as the fixed step.
    """
    return _adaptive_step(
        make_distributed2d_step_fn(grid, params, mesh, _traced_dt=True,
                                   **kwargs),
        params, mesh, cfl, dt_min, dt_max)


def _distribute_blocks(state, grid, mesh, n_dec, capacity):
    """Partition ``state`` onto a block mesh by block ownership (the
    first ``n_dec`` axes decomposed)."""
    shape = tuple(mesh.shape)
    if len(shape) != n_dec:
        raise ValueError("distribute_state_%dd needs a %d-D mesh, got shape "
                         "%r" % (n_dec, n_dec, shape))
    x = _host(state.x).astype(np.float32, copy=False)
    block = []
    for a in range(n_dec):
        width = grid.dims[a] // shape[a] * grid.cell_size
        block.append(np.clip(((x[:, a] - grid.lo[a]) // width).astype(
            np.int64), 0, shape[a] - 1))
    owner = np.ravel_multi_index(block, shape)
    return _partition(state._replace(x=x), owner, mesh, capacity, "block")


def distribute_state_2d(state, grid, mesh, capacity=None):
    """Partition a global state onto a 2-D mesh by block ownership.

    As :func:`~tpgsd_torch.sph.distributed.distribute_state`: shard ``i *
    py + j`` holds the particles of block ``(i, j)`` in original-index
    ``pid`` order, on its device; ``capacity`` defaults to the smallest
    multiple of 8 at least twice the densest block's population, and a
    block past it raises ``ValueError``.

    Returns:
        ``(DistState, capacity)``.
    """
    return _distribute_blocks(state, grid, mesh, 2, capacity)
