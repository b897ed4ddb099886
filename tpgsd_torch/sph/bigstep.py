"""Slab-sequential SPH step for particle counts whose dense cell layout
would not fit the card (torch counterpart of ``tpgsd.sph.bigstep``).

The global step (:func:`tpgsd_torch.sph.make_step_fn`) lays the whole
domain out densely at once: both tiers' ``[F, C, K]`` SoA, the pair
passes' planes and an int64 ``[C, K]`` gather map per tier, tens of
bytes per slot.  This step keeps only per-particle arrays for the whole
domain.  The x-major cell order makes every x-slab a contiguous cell
range and, after the one global cell sort, a contiguous range of sorted
particles, so a Python loop over the ``n_slabs`` slabs

1. lays out only one slab's cells plus ``_PAD`` halo planes each side,
   gathering the sorted features by the index rule of
   :func:`~tpgsd_torch.sph.cells.scatter_to_cells_soa` on a slice of the
   cells' first sorted positions and counts,
2. runs the unchanged pair passes on that slab's extended grid (the CUDA
   kernels on the card, the plain passes elsewhere),
3. gathers the core cells' per-slot results through a window of
   ``w_rows`` sorted rows starting at the slab's first particle and
   writes them into a full-length sorted-order output.  Slabs write in
   ascending order, so a row's last writer is its owning slab; a slab
   with more particles than the window is counted in ``aux[3]``.

The kernels take pair separations as differences of absolute positions,
so positions are not shifted into a slab frame: every core centre sees
the neighbours and the cell order it sees in the global step.  The slab
offsets are host integers and every per-slab scalar (the window's first
row, the slab's row count, its shortfall) stays on the device, so a step
without emission makes no host sync.

Peak memory is the per-particle arrays plus one slab's planes.
Per-particle int64 arrays (8 bytes each): the cell ids and the sort's
``order``, the ``cummax`` of the run starts (values and indices) and the
slots, and the padded cell ids and slots of the window; ``starts`` and
``counts`` are int64 per cell.

Matches the reference's semantics: summation and continuity density,
the two-tier spill and the single-tier layouts, ``n_fixed`` and
``density_renorm``, the same aux and the same errors; ``periodic`` and
``xsph`` are not supported, as there.  ``slab_emit`` streams each slab's
integrated rows to the host while later slabs compute
(:class:`tpgsd_torch.io_runtime.SlabDumpChannel`).
"""

import numpy as np
import torch

from . import ops
from .cells import CellGrid, cell_id, sorted_runs
from .kernels import WendlandC2
from .step import (
    SPHState,
    _carried_density,
    _floor_density,
    _integrate,
    _resolve_device,
    resolve_policy,
)

#: halo planes on each side of a slab (2: one so density is valid one
#: plane into the halo, one more so those densities see their neighbours)
_PAD = 2


def _slab_geometry(grid, n_slabs):
    """``(nxl, c_ext, ext_grid)``: core planes a slab, cells of its
    extended range, and the extended range as a grid."""
    nx, ny, nz = grid.dims
    if n_slabs < 1 or nx % n_slabs != 0:
        raise ValueError(
            "grid nx=%d must be a multiple of n_slabs=%d" % (nx, n_slabs)
        )
    nxl = nx // n_slabs
    ext_grid = CellGrid(
        lo=(0.0, 0.0, 0.0), cell_size=grid.cell_size,
        dims=(nxl + 2 * _PAD, ny, nz), capacity=grid.capacity,
    )
    return nxl, ext_grid.n_cells, ext_grid


def _sorted_rows(state, grid, kt, continuity):
    """The global pass, the only full-domain work of a step: one cell
    sort of ``state.x`` -> ``(order, cid_pad, slot_pad, vs_t,
    starts_ext, counts_ext, cell_overflow)``: the sorted features as rows
    ``vs_t [nf, n + 1]`` (x, v[, rho]; a zero column at ``n``, the empty
    slot of :func:`~tpgsd_torch.sph.cells.scatter_to_cells_soa`), the
    sorted cell ids and slots with a row ``n`` of cell ``C`` (no slab's
    core) and slot 0, and each cell's first sorted row and count, padded
    with ``_PAD`` empty planes each side."""
    x = state.x
    n = x.shape[0]
    c = grid.n_cells
    pad_cells = _PAD * grid.dims[1] * grid.dims[2]
    order, cid_s, slot, starts = sorted_runs(cell_id(x, grid), c)
    cell_ovf = (slot >= kt).sum().to(torch.int32)
    vs_t = x.new_zeros((7 if continuity else 6, n + 1))
    vs_t[:3, :n] = x.t()[:, order]
    vs_t[3:6, :n] = state.v.t()[:, order]
    if continuity:
        vs_t[6, :n] = state.rho[order]
    cid_pad = torch.cat([cid_s, cid_s.new_full((1,), c)])
    slot_pad = torch.cat([slot, slot.new_zeros(1)])
    del cid_s, slot
    pad = starts.new_zeros(pad_cells)
    starts_ext = torch.cat([pad, starts, starts.new_full((pad_cells,), n)])
    counts = torch.diff(starts, append=starts.new_full((1,), n))
    counts_ext = torch.cat([pad, counts, pad])
    return order, cid_pad, slot_pad, vs_t, starts_ext, counts_ext, cell_ovf


def _slab_tiers(vs_t, st, ct, k, spill):
    """One slab's extended range laid out from the sorted rows ``vs_t``
    (``st``/``ct``: its cells' first sorted rows and counts) by the index
    rule of :func:`~tpgsd_torch.sph.cells.scatter_to_cells_soa`: the
    tiers ``(soa [nf, c_ext, K], live [c_ext, K])``, A and with
    ``spill`` B (slots ``K..2K-1`` of each cell)."""
    n = vs_t.shape[1] - 1

    def tier(base):
        js = torch.arange(base, base + k, dtype=torch.int64,
                          device=vs_t.device)
        live = js[None, :] < ct[:, None]
        idx = torch.where(live, st[:, None] + js[None, :], n)
        return vs_t[:, idx], live

    return (tier(0), tier(k)) if spill else (tier(0),)


def slab_tiers(state, grid, n_slabs, slabs, spill=True):
    """The pair passes' inputs on the slab path: for each slab in
    ``slabs``, yields ``(s, ext_grid, tiers)`` with the tiers of
    :func:`_slab_tiers` (x, v[, rho] rows) that
    :func:`make_slab_step_fn` lays out for slab ``s`` of ``state``, from
    the same global pass (``state.rho`` present: continuity's rows).
    For holding the pair kernels against their plain versions at the
    slab path's shapes."""
    nxl, c_ext, ext_grid = _slab_geometry(grid, int(n_slabs))
    k = grid.capacity
    _o, _c, _s, vs_t, starts_ext, counts_ext, _v = _sorted_rows(
        state, grid, 2 * k if spill else k, state.rho is not None
    )
    nynz = grid.dims[1] * grid.dims[2]
    for s in slabs:
        c0e = s * nxl * nynz
        yield s, ext_grid, _slab_tiers(vs_t, starts_ext[c0e:c0e + c_ext],
                                       counts_ext[c0e:c0e + c_ext], k, spill)


def make_slab_step_fn(
    grid,
    params,
    n_slabs,
    window=None,
    kernel=WendlandC2,
    use_kernels="auto",
    n_fixed=0,
    density_renorm=False,
    spill="auto",
    slab_emit=None,
    density_mode="summation",
    delta_sph=0.1,
    device="cuda",
):
    """Build the memory-bounded slab-sequential step for states on
    ``device``.

    Args:
        grid: global :class:`~tpgsd_torch.sph.cells.CellGrid`;
            ``dims[0]`` must be a multiple of ``n_slabs``.
        n_slabs: sequential x-slabs per step.  More slabs = less peak
            memory and ``2 * _PAD / (dims[0] / n_slabs)`` more recomputed
            halo planes of pair work per slab.
        window: compaction window rows per slab (default ``ceil(3 n /
            n_slabs)``).  Rows of a slab past it are counted in
            ``aux[3]``.
        use_kernels / spill / kernel / n_fixed / density_renorm /
            density_mode / delta_sph: as in
            :func:`tpgsd_torch.sph.make_step_fn`, resolved by
            :func:`~tpgsd_torch.sph.step.resolve_policy` on one slab's
            extended grid (``spill=True`` without kernels runs the plain
            spill ops).
        slab_emit: host callback ``(step, slab, p0, rows, pids, payload)
            -> None``: as soon as slab ``s`` is done, its window of final
            integrated rows (``payload[w_rows, 8]`` float32, columns
            ``x(3), v(3), rho, p``; ``pids[w_rows]`` int32 particle ids,
            -1 past the particle count; ``p0`` the window's first sorted
            row and ``rows`` the slab's true row count, both ints) is
            copied to pinned host memory on a side CUDA stream, and the
            callback runs on a host thread, in slab order, while later
            slabs compute.  The returned step then takes a second
            argument, ``step(state, dump)``, with ``dump`` from
            :meth:`SlabDumpChannel.dump` (emit) or
            :meth:`SlabDumpChannel.no_dump` (silent).
        device: the device of the states the step takes (the card unless
            the caller asks for ``"cpu"``).

    Returns:
        ``step(state) -> (state, (rho, p, cell_overflow,
        window_overflow))`` (``step(state, dump)`` with ``slab_emit``),
        the overflows 0-d int32 device tensors; it carries ``resolved =
        {"use_kernels", "spill", "density_mode"}``.
    """
    if density_mode not in ("summation", "continuity"):
        raise ValueError("density_mode must be summation or continuity")
    continuity = density_mode == "continuity"
    if continuity and density_renorm:
        raise ValueError(
            "density_renorm corrects summation's free-surface support "
            "deficit; continuity mode has no deficit to correct - use "
            "delta_sph for its noise control instead"
        )

    S = int(n_slabs)
    nxl, c_ext, ext_grid = _slab_geometry(grid, S)
    nynz = grid.dims[1] * grid.dims[2]
    k = grid.capacity
    core0 = _PAD * nynz  # first core cell of a slab's extended range

    dev = _resolve_device(device)
    use_kernels, spill = resolve_policy(dev.type, ext_grid, use_kernels, spill)
    resolved = {"use_kernels": use_kernels, "spill": spill,
                "density_mode": density_mode}
    kt = 2 * k if spill else k  # retained slots per cell

    pairs = ops.pair_ops(use_kernels, spill, continuity)

    lo_np = np.asarray(grid.lo, np.float32)
    hi_np = lo_np + grid.cell_size * np.asarray(grid.dims, np.float32)
    lo = torch.from_numpy(lo_np).to(dev)
    hi = torch.from_numpy(hi_np).to(dev)
    gravity = torch.from_numpy(np.asarray(params.gravity, np.float32)).to(dev)

    def integrate(x, v, out, fixed, rho_cur=None):
        """The global step's integration (:func:`~tpgsd_torch.sph.step.
        _integrate`) from per-particle result rows ``out`` ([acc3 | rho |
        p | live], or [acc3 | drho | 0 | live] with the carried density
        ``rho_cur``), shared by the epilogue and the emitted windows, so
        streamed rows are the post-step state bit for bit.  Rows of
        dropped or never-written particles are zero (ballistic, ``rho0``,
        ``p = 0``; continuity keeps the carried density)."""
        acc = out[:, :3] + gravity
        if continuity:
            rho, p = _carried_density(rho_cur, out[:, 3], params.dt, params)
        else:
            live = out[:, 5] > 0.5
            rho = torch.where(live, out[:, 3], params.rho0)
            p = torch.where(live, out[:, 4], 0.0)
        x_new, v_new = _integrate(x, v, acc, params.dt, params, lo, hi)
        if fixed is not None:
            x_new = torch.where(fixed[:, None], x, x_new)
            v_new = torch.where(fixed[:, None], 0.0, v_new)
        return x_new, v_new, rho, p

    def finish_rho(rho, mask):
        return _floor_density(rho, mask, params, density_renorm)

    def bundle_of(acc, col3, col4, mask):
        """``[c_ext, K, 6]`` per-slot results: acc3 | col3 | col4 | live."""
        return torch.cat([acc, col3[..., None], col4[..., None],
                          mask[..., None].to(acc.dtype)], dim=-1)

    def slab_bundle(vs_t, st, ct):
        """The ``[c_ext, kt, 6]`` per-slot results of one slab's extended
        range (``st``/``ct``: its cells' first sorted rows and counts)."""
        tiers = _slab_tiers(vs_t, st, ct, k, spill)
        soa_a, m_a = tiers[0]
        if spill:
            soa_b, m_b = tiers[1]
            if continuity:
                rho_a, p_a = finish_rho(soa_a[6], m_a)
                rho_b, p_b = finish_rho(soa_b[6], m_b)
                out_a, out_b = pairs.momentum(
                    soa_a[:3], soa_a[3:6], rho_a, p_a, m_a,
                    soa_b[:3], soa_b[3:6], rho_b, p_b, m_b,
                    ext_grid, params, delta_sph=delta_sph, kernel=kernel,
                )  # [c_ext, K, 4] each: acc3 | drho
                zero = out_a.new_zeros(out_a.shape[:-1])
                return torch.cat([
                    bundle_of(out_a[..., :3], out_a[..., 3], zero, m_a),
                    bundle_of(out_b[..., :3], out_b[..., 3], zero, m_b),
                ], dim=1)
            rho_a, rho_b = pairs.density(soa_a[:3], m_a, soa_b[:3], m_b,
                                         ext_grid, params, kernel=kernel)
            rho_a, p_a = finish_rho(rho_a, m_a)
            rho_b, p_b = finish_rho(rho_b, m_b)
            acc_a, acc_b = pairs.momentum(
                soa_a[:3], soa_a[3:6], rho_a, p_a, m_a,
                soa_b[:3], soa_b[3:6], rho_b, p_b, m_b,
                ext_grid, params, kernel=kernel,
            )  # [c_ext, K, 3] each
            return torch.cat([bundle_of(acc_a, rho_a, p_a, m_a),
                              bundle_of(acc_b, rho_b, p_b, m_b)], dim=1)
        if continuity:
            rho_d, p_d = finish_rho(soa_a[6], m_a)
            out4 = pairs.momentum(soa_a[:3], soa_a[3:6], rho_d, p_d, m_a,
                                  ext_grid, params, delta_sph=delta_sph,
                                  kernel=kernel)
            out4 = out4.permute(1, 2, 0)
            return bundle_of(out4[..., :3], out4[..., 3],
                             out4.new_zeros(out4.shape[:-1]), m_a)
        rho_d, p_d = finish_rho(pairs.density(soa_a[:3], m_a, ext_grid,
                                              params, kernel=kernel), m_a)
        acc = pairs.momentum(soa_a[:3], soa_a[3:6], rho_d, p_d, m_a, ext_grid,
                             params, kernel=kernel)
        return bundle_of(acc.permute(1, 2, 0), rho_d, p_d, m_a)

    def check(state, dump):
        if state.x.device != dev:
            raise ValueError(
                "step built for %s got a state on %s" % (dev, state.x.device)
            )
        if slab_emit is not None and dump is None:
            raise TypeError(
                "this step was built with slab_emit: call step(state, dump) "
                "where dump is chan.dump(step) for an emitting step or "
                "chan.no_dump() for a silent one (SlabDumpChannel)"
            )
        if continuity and state.rho is None:
            raise ValueError(
                "density_mode='continuity' needs state.rho - seed it with "
                "tpgsd_torch.sph.slab_init_density(state, grid, params, "
                "n_slabs)"
            )

    @torch.inference_mode()
    def step(state, dump=None):
        check(state, dump)
        emit = slab_emit is not None and bool(dump.emit)
        x, v = state.x, state.v
        n = x.shape[0]
        w_rows = int(window) if window else -(-3 * n // S)

        order, cid_pad, slot_pad, vs_t, starts_ext, counts_ext, cell_ovf = \
            _sorted_rows(state, grid, kt, continuity)
        if emit:
            pid_pad = torch.cat([order, order.new_full((1,), -1)]).int()
        window_rows = torch.arange(w_rows, dtype=torch.int64, device=dev)

        out = x.new_zeros((n + 1, 6))  # sorted order; row n is discarded
        win_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(S):
            c0e = s * nxl * nynz  # the slab's extended range in starts_ext
            bundle = slab_bundle(vs_t, starts_ext[c0e:c0e + c_ext],
                                 counts_ext[c0e:c0e + c_ext])
            p0 = starts_ext[c0e + core0]  # the slab's first sorted row
            rows = torch.clamp(p0 + window_rows, max=n)
            cw = cid_pad[rows] - (s * nxl - _PAD) * nynz
            sw = slot_pad[rows]
            flat = (torch.clamp(cw, 0, c_ext - 1) * kt
                    + torch.clamp(sw, 0, kt - 1))
            win = bundle.reshape(-1, 6)[flat]
            # dropped (cell-overflow) particles: the clamped gather read a
            # live slot, so zero their rows (the global step's sentinel)
            win = torch.where((sw < kt)[:, None], win, 0.0)
            out.index_copy_(0, rows, win)
            rows_s = starts_ext[c0e + core0 + nxl * nynz] - p0
            win_ovf += torch.clamp(rows_s - w_rows, min=0)
            if emit:
                pids = pid_pad[rows]
                xvr = vs_t[:, rows]
                fixed = (pids >= 0) & (pids < n_fixed) if n_fixed > 0 else None
                xw, vw, rho_w, p_w = integrate(
                    xvr[:3].t(), xvr[3:6].t(), win, fixed,
                    rho_cur=xvr[6] if continuity else None,
                )
                payload = torch.cat([xw, vw, rho_w[:, None], p_w[:, None]],
                                    dim=-1)
                dump.pipe.submit(slab_emit, dump.step, s, p0, rows_s, pids,
                                 payload)
        del vs_t, cid_pad, slot_pad, bundle

        # the inverse permutation as a scatter of the sorted rows
        out_p = out.new_empty((n, 6))
        out_p.index_copy_(0, order, out[:n])
        del out
        fixed = torch.arange(n, device=dev) < n_fixed if n_fixed > 0 else None
        x_new, v_new, rho, p = integrate(
            x, v, out_p, fixed, rho_cur=state.rho if continuity else None
        )
        return (
            SPHState(x=x_new, v=v_new, rho=rho if continuity else None),
            (rho, p, cell_ovf, win_ovf.to(torch.int32)),
        )

    step.resolved = resolved
    return step


def slab_init_density(state, grid, params, n_slabs, **kw):
    """Seed continuity's carried density at scales where the global
    layout would not fit (the slab twin of
    :func:`tpgsd_torch.sph.init_density`): one summation slab step
    evaluates the SPH density at ``state.x`` (its aux density comes from
    the pre-step positions) and attaches it as ``state.rho``.  Extra
    ``kw`` go to :func:`make_slab_step_fn` (``spill``, ``use_kernels``,
    ``window``, ``device``, ...)."""
    step = make_slab_step_fn(grid, params, n_slabs, density_mode="summation",
                             **kw)
    return state._replace(rho=step(state)[1][0])
