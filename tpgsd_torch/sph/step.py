"""Weakly-compressible SPH step (torch counterpart of ``tpgsd.sph.step``):
density -> EOS -> forces -> integrate.

Formulation (standard WCSPH):

* density summation  rho_i = sum_j m W(r_ij, h)
* Tait EOS           p = (rho0 c0^2 / gamma) ((rho/rho0)^gamma - 1)
* momentum           dv_i/dt = -sum_j m (p_i/rho_i^2 + p_j/rho_j^2
                      + Pi_ij) grad_W_ij + g   (Monaghan artificial
                      viscosity Pi_ij)
* symplectic Euler (kick-drift) + reflective box walls

All pair interactions happen inside 27-cell neighborhoods of the dense
cell layout (:mod:`tpgsd_torch.sph.cells`).  The plain pair machinery
here (:func:`_density_blocks`, :func:`_accel_blocks`) works on the SoA
layout ``[F, n_cells, K]`` with a centre tier and a neighbour tier, so
it serves both the single-tier step (the tier is its own neighbour) and
the plain versions of the spill ops in :mod:`tpgsd_torch.sph.ops`.  On
CUDA the spill step runs the hand-written pair kernels instead.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .cells import (
    build_cells,
    build_cells_spill,
    gather_from_cells,
    neighbor_table,
    scatter_to_cells_soa,
)
from .kernels import WendlandC2


class SPHParams(NamedTuple):
    """Physical + numerical parameters (host constants)."""

    mass: float  # per-particle mass
    h: float  # smoothing length
    dt: float  # time step
    rho0: float = 1000.0  # rest density
    c0: float = 40.0  # artificial speed of sound
    gamma: float = 7.0  # Tait exponent
    alpha: float = 0.1  # artificial viscosity strength
    gravity: tuple = (0.0, 0.0, -9.81)
    wall_damping: float = 0.5  # velocity retained on wall reflection
    eps: float = 0.01  # viscosity denominator regularizer (times h^2)
    velocity_damping: float = 1.0  # global per-step velocity factor
    dim: int = 3  # spatial dimension (only the kernel normalization)


class SPHState(NamedTuple):
    """Dynamic state: positions and velocities, ``[N, 3]`` float32."""

    x: torch.Tensor
    v: torch.Tensor


def tait_pressure(rho, params):
    """Tait equation of state."""
    B = params.rho0 * params.c0**2 / params.gamma
    return B * ((rho / params.rho0) ** params.gamma - 1.0)


def _renormalize_density(rho, params):
    """Clipped rest-volume Shepard normalization of summation density,
    whose closed form is the Hughes-Graham floor ``max(rho, rho0)`` (the
    derivation is in ``tpgsd.sph.step._renormalize_density``)."""
    return torch.clamp(rho, min=params.rho0)


#: values per ``[B, K, 27K]`` pair plane of the plain pair passes; bounds
#: their peak memory at about 16 such planes (0.5 GB)
_PAIR_PLANE = 1 << 23


def _cell_blocks(c, k):
    """Cell ranges of the plain pair passes."""
    block = max(1, _PAIR_PLANE // (27 * k * k))
    return [(c0, min(c, c0 + block)) for c0 in range(0, c, block)]


def _with_sentinel_cell(a, fill):
    """Append one cell of ``fill`` along the cell axis (axis -2)."""
    pad = a.new_full(a.shape[:-2] + (1, a.shape[-1]), fill)
    return torch.cat([a, pad], dim=-2)


def _gather_nbr(a, nb):
    """``[..., C+1, K]`` -> ``[..., B, 1, 27K]`` neighbour slots of the
    cells whose ``[B, 27]`` neighbour rows are ``nb``."""
    g = a[..., nb, :]  # [..., B, 27, K]
    return g.reshape(g.shape[:-2] + (1, g.shape[-2] * g.shape[-1]))


def _distance(d):
    """``|d|`` over the leading (x, y, z) axis of pair differences.

    The root comes from ``torch.linalg.vector_norm``, not from an
    elementwise ``torch.sqrt``: on the CPU, float32 ``torch.sqrt`` of a
    large tensor was seen to return values off by up to 3.3e-4 (relative)
    over one worker thread's share of the tensor, at the first calls in
    some processes (ROADMAP "Faults found")."""
    return torch.linalg.vector_norm(d, dim=0)


def _pair_terms(xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel):
    """Shared pair machinery of the momentum equation on SoA blocks
    (centres ``[3, B, K, 1]``, neighbours ``[3, B, 1, 27K]``): returns
    ``(dx, dwr, press_plus_pi, vdotx)``."""
    h2eps = params.eps * params.h * params.h
    dx = xb - y  # [3, B, K, 27K]
    dv = vb - vy
    r2 = torch.sum(dx * dx, dim=0)
    r = _distance(dx)
    dwr = kernel.dw_over_r(r, params.h, dim=params.dim)  # [B, K, 27K]

    # pressure term
    press = pb / rhob**2 + py / rhoy**2

    # Monaghan artificial viscosity
    vdotx = torch.sum(dv * dx, dim=0)
    mu = vdotx / (r2 + h2eps)
    rho_bar = 0.5 * (rhob + rhoy)
    pi = torch.where(
        vdotx < 0.0,
        -params.alpha * params.c0 * params.h * mu / rho_bar,
        torch.zeros((), dtype=mu.dtype, device=mu.device),
    )
    return dx, dwr, press + pi, vdotx


def _density_blocks(xc, mc, xn, mn, nbr, params, kernel):
    """Plain per-slot density of centre tier ``(xc [3, C, K], mc [C, K])``
    from neighbour tier ``(xn, mn)`` over the 27-cell table ``nbr``
    (``[C, 27]`` int64, sentinel ``C``) -> ``[C, K]``."""
    c, k = mc.shape
    xn_s = _with_sentinel_cell(xn, 0.0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_empty((c, k))
    for c0, c1 in _cell_blocks(c, k):
        nb = nbr[c0:c1]
        y = _gather_nbr(xn_s, nb)  # [3, B, 1, 27K]
        ym = _gather_nbr(mn_s, nb)  # [B, 1, 27K]
        r = _distance(xc[:, c0:c1, :, None] - y)
        w = kernel.w(r, params.h, dim=params.dim) * ym
        out[c0:c1] = params.mass * torch.sum(w, dim=-1) * mc[c0:c1]
    return out


def _accel_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params,
                  kernel):
    """Plain per-slot acceleration (pressure + viscosity) of centre tier
    ``c`` from neighbour tier ``n`` -> ``[3, C, K]``.  Dead slots must
    carry a positive density (the step sets ``rho0``, ``p = 0``)."""
    c, k = mc.shape
    xn_s = _with_sentinel_cell(xn, 0.0)
    vn_s = _with_sentinel_cell(vn, 0.0)
    rhon_s = _with_sentinel_cell(rhon, params.rho0)
    pn_s = _with_sentinel_cell(pn, 0.0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_empty((3, c, k))
    for c0, c1 in _cell_blocks(c, k):
        nb = nbr[c0:c1]
        dx, dwr, press_pi, _ = _pair_terms(
            xc[:, c0:c1, :, None], vc[:, c0:c1, :, None],
            rhoc[c0:c1, :, None], pc[c0:c1, :, None],
            _gather_nbr(xn_s, nb), _gather_nbr(vn_s, nb),
            _gather_nbr(rhon_s, nb), _gather_nbr(pn_s, nb),
            params, kernel,
        )
        scale = -params.mass * press_pi * dwr * _gather_nbr(mn_s, nb)
        acc = torch.sum(scale * dx, dim=-1)  # [3, B, K]
        out[:, c0:c1] = acc * mc[c0:c1]
    return out


@functools.lru_cache(maxsize=4)
def neighbor_index(grid, device):
    """The ``[C, 27]`` neighbour table as an int64 tensor on ``device``
    (cached per grid and device; callers must not write to it)."""
    return torch.from_numpy(neighbor_table(grid).astype(np.int64)).to(device)


def _resolve_device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _not_ported(name, item):
    return NotImplementedError(
        "%s is not ported to tpgsd_torch yet (ROADMAP queue 1, item %s)"
        % (name, item)
    )


def resolve_policy(device_type, grid, use_kernels="auto", spill="auto"):
    """``(use_kernels, spill)`` of :func:`make_step_fn` for states on a
    ``device_type`` (``"cuda"``, ``"cpu"``, ...) device.

    On CUDA, ``"auto"`` means the kernels: a configuration they do not
    take (a capacity past :data:`ops.MAX_CAPACITY`, or ``spill=False``)
    raises ``NotImplementedError`` instead of running the plain pair
    passes on the card.  Only an explicit ``use_kernels=False`` runs the
    plain passes there.  Elsewhere ``"auto"`` is the plain path, and
    ``spill="auto"`` follows the kernels."""
    from .ops import MAX_CAPACITY, spill_supported

    on_cuda = device_type == "cuda"
    if use_kernels == "auto":
        use_kernels = on_cuda
    if use_kernels:
        if not on_cuda:
            raise ValueError(
                "use_kernels=True needs a CUDA device; got %s" % (device_type,)
            )
        if not spill_supported(grid):
            raise NotImplementedError(
                "the CUDA pair kernels take 1 <= capacity <= %d; capacity %d "
                "needs the lane-padded kernels (ROADMAP queue 2, kernels "
                "7-9), or use_kernels=False" % (MAX_CAPACITY, grid.capacity)
            )
        if spill is False:
            raise NotImplementedError(
                "the single-tier kernel dispatch is not ported yet "
                "(ROADMAP queue 2, kernels 7-9); use spill=True, or "
                "use_kernels=False"
            )
    if spill == "auto":
        spill = bool(use_kernels)
    return bool(use_kernels), bool(spill)


def make_step_fn(
    grid,
    params,
    kernel=WendlandC2,
    use_kernels="auto",
    n_fixed=0,
    periodic=False,
    density_renorm=False,
    xsph=0.0,
    surface_tension=0.0,
    spill="auto",
    density_mode="summation",
    sharding=None,
    device="cpu",
):
    """Build the SPH step for states on ``device``.

    Returns ``step(state) -> (state, aux)`` with ``aux = (rho, p,
    overflow)``; ``overflow`` is a 0-d device tensor (reading it waits
    for the device).  The step runs under ``torch.inference_mode()``.

    Args:
        grid: static :class:`~tpgsd_torch.sph.cells.CellGrid`.
        params: :class:`SPHParams`.
        kernel: smoothing kernel class.
        use_kernels: run the density/acceleration pair passes through the
            hand-written CUDA kernels (:mod:`tpgsd_torch.sph.ops`).
            ``"auto"`` selects them on a CUDA ``device`` and the plain
            pair passes elsewhere; on CUDA a configuration the kernels
            do not take raises (see :func:`resolve_policy`).
        n_fixed: the first ``n_fixed`` particles are static boundary
            particles: SPH sources that never move.
        density_renorm: floor summation density at ``rho0`` (the clipped
            Shepard renormalization).
        spill: two-tier cell layout: ``grid.capacity`` sizes the main
            tier and an equal spill tier holds the excess of denser
            cells.  ``"auto"`` turns it on exactly when the kernels run.
            ``spill=True`` without kernels runs the plain versions of
            the spill ops (any device).
        periodic, xsph, surface_tension, density_mode="continuity",
            sharding: not ported yet; each raises ``NotImplementedError``
            naming its ROADMAP item.
        device: the device of the states the step takes.

    The returned function carries ``resolved = {"use_kernels", "spill",
    "density_mode"}``.
    """
    from . import ops  # ops imports this module's plain pair passes

    if periodic:
        raise _not_ported("periodic", 5)
    if xsph:
        raise _not_ported("xsph", 5)
    if surface_tension:
        raise _not_ported("surface_tension", 5)
    if density_mode == "continuity":
        raise _not_ported("density_mode='continuity'", "5 (slice B)")
    if density_mode != "summation":
        raise ValueError("unknown density_mode: %r" % (density_mode,))
    if sharding is not None:
        raise _not_ported("the GSPMD sharding hint", 12)

    dev = _resolve_device(device)
    use_kernels, spill = resolve_policy(
        dev.type, grid, use_kernels, spill
    )
    resolved = {
        "use_kernels": use_kernels,
        "spill": spill,
        "density_mode": density_mode,
    }

    c = grid.n_cells
    k = grid.capacity
    lo_np = np.asarray(grid.lo, np.float32)
    hi_np = lo_np + grid.cell_size * np.asarray(grid.dims, np.float32)
    lo = torch.from_numpy(lo_np).to(dev)
    hi = torch.from_numpy(hi_np).to(dev)
    gravity = torch.from_numpy(np.asarray(params.gravity, np.float32)).to(dev)
    dt = params.dt

    def _finish(x, v, out, overflow):
        """Integrate/boundary tail: ``out`` is the per-particle gathered
        bundle [acc3 | rho | p]."""
        acc = out[:, :3] + gravity
        rho = out[:, 3]
        p = out[:, 4]

        # symplectic Euler: kick then drift
        v_new = (v + dt * acc) * params.velocity_damping
        x_new = x + dt * v_new

        # reflective walls with damping: reflect, then clip
        under = x_new < lo
        over = x_new > hi
        reflected = torch.where(under, 2.0 * lo - x_new, x_new)
        reflected = torch.where(over, 2.0 * hi - reflected, reflected)
        x_new = torch.clamp(reflected, lo, hi)
        bounce = under | over
        v_new = torch.where(bounce, -params.wall_damping * v_new, v_new)

        if n_fixed > 0:
            x_new = torch.cat([x[:n_fixed], x_new[n_fixed:]])
            v_new = torch.cat([v.new_zeros((n_fixed, 3)), v_new[n_fixed:]])
        return SPHState(x=x_new, v=v_new), (rho, p, overflow)

    def finish_rho(rho, mask):
        """Floor, renormalize and fill dead slots (rho0, p = 0: keeps
        p/rho^2 finite in the acceleration pass)."""
        m = mask[:c]
        rho = torch.where(m, torch.clamp(rho, min=0.1 * params.rho0),
                          params.rho0)
        if density_renorm:
            rho = _renormalize_density(rho, params)
        p = torch.where(m, tait_pressure(rho, params), 0.0)
        return rho, p

    def to_particles(acc, rho, p, cells):
        """One particle-order gather of the per-slot ``[C, kc, 3]`` acc,
        ``[C, kc]`` rho and p (kc = slots of all tiers)."""
        bundle = torch.cat([acc, rho[..., None], p[..., None]], dim=-1)
        # sentinel row for dropped particles: rho0, zero p/acc
        sent = bundle.new_zeros((1,) + tuple(bundle.shape[1:]))
        sent[..., 3] = params.rho0
        return gather_from_cells(
            torch.cat([bundle, sent]), cells, grid, capacity=bundle.shape[1]
        )

    def _check(state):
        if state.x.device != dev:
            raise ValueError(
                "step built for %s got a state on %s" % (dev, state.x.device)
            )

    if spill:
        density_spill = ops.density_spill if use_kernels else ops.density_spill_plain
        accel_spill = ops.accel_spill if use_kernels else ops.accel_spill_plain

        @torch.inference_mode()
        def step_spill(state):
            _check(state)
            x, v = state.x, state.v
            cells, sp = build_cells_spill(x, grid, k)
            xv = torch.cat([x, v], dim=-1)
            soa_a = scatter_to_cells_soa(xv, cells, grid)
            soa_b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
            rho_a, rho_b = density_spill(
                soa_a[:3], cells.mask, soa_b[:3], sp.mask, grid, params,
                kernel=kernel,
            )
            rho_a, p_a = finish_rho(rho_a, cells.mask)
            rho_b, p_b = finish_rho(rho_b, sp.mask)
            acc_a, acc_b = accel_spill(
                soa_a[:3], soa_a[3:], rho_a, p_a, cells.mask,
                soa_b[:3], soa_b[3:], rho_b, p_b, sp.mask,
                grid, params, kernel=kernel,
            )
            out = to_particles(
                torch.cat([acc_a, acc_b], dim=1),  # [C, 2K, 3]
                torch.cat([rho_a, rho_b], dim=1),
                torch.cat([p_a, p_b], dim=1),
                cells,
            )
            return _finish(x, v, out, cells.overflow)

        step_spill.resolved = resolved
        return step_spill

    nbr = neighbor_index(grid, dev)

    @torch.inference_mode()
    def step(state):
        _check(state)
        x, v = state.x, state.v
        cells = build_cells(x, grid)
        xv = scatter_to_cells_soa(torch.cat([x, v], dim=-1), cells, grid)
        dense_x, dense_v = xv[:3], xv[3:]
        m = cells.mask[:c]
        rho = _density_blocks(dense_x, m, dense_x, m, nbr, params, kernel)
        rho, p = finish_rho(rho, cells.mask)
        acc = _accel_blocks(
            dense_x, dense_v, rho, p, m, dense_x, dense_v, rho, p, m,
            nbr, params, kernel,
        )
        out = to_particles(acc.permute(1, 2, 0), rho, p, cells)
        return _finish(x, v, out, cells.overflow)

    step.resolved = resolved
    return step
