"""Weakly-compressible SPH step (torch counterpart of ``tpgsd.sph.step``):
density -> EOS -> forces -> integrate.

Formulation (standard WCSPH):

* density summation  rho_i = sum_j m W(r_ij, h), or in continuity mode
                      drho_i/dt = sum_j m (v_i - v_j) . grad_W_ij plus
                      delta-SPH diffusion, with rho carried in the state
* Tait EOS           p = (rho0 c0^2 / gamma) ((rho/rho0)^gamma - 1)
* momentum           dv_i/dt = -sum_j m (p_i/rho_i^2 + p_j/rho_j^2
                      + Pi_ij) grad_W_ij + g   (Monaghan artificial
                      viscosity Pi_ij)
* symplectic Euler (kick-drift) + reflective box walls; the options:
  XSPH drift smoothing, Akinci surface tension, and the energy rate

All pair interactions happen inside 27-cell neighborhoods of the dense
cell layout (:mod:`tpgsd_torch.sph.cells`).  The plain pair machinery
here (:func:`_density_blocks`, :func:`_accel_blocks`,
:func:`_accel_drho_blocks`, :func:`_xsph_blocks`,
:func:`_st_normals_blocks`, :func:`_st_force_blocks`,
:func:`_energy_blocks`) works on the SoA layout ``[F, n_cells, K]`` with
a centre tier and a neighbour tier, so it serves both the single-tier
step (the tier is its own neighbour) and the plain versions of the pair
ops in :mod:`tpgsd_torch.sph.ops`; it evaluates only the cells with a
live centre.  On CUDA both layouts run the hand-written pair kernels
instead.

Periodic boundaries reach the plain pair passes as a wrapped neighbour
table plus minimum-image separations, and the kernels as a pre-shifted
ghost-cell halo (:mod:`tpgsd_torch.sph.ops`): two independent routes.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .cells import (
    build_cells,
    build_cells_spill,
    cell_bounds,
    neighbor_table,
    scatter_to_cells_soa,
    wrap_axes,
)
from .kernels import WendlandC2
from ..utils.trace import get_tracer


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
    """Dynamic state: positions and velocities, ``[N, 3]`` float32.

    ``rho`` (``[N]``) is carried only in continuity-density mode
    (``make_step_fn(density_mode="continuity")``), where density is a
    state variable evolved by the continuity equation; the default
    summation mode leaves it ``None``.  Seed it with
    :func:`init_density`.
    """

    x: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor = None


def tait_pressure(rho, params):
    """Tait equation of state."""
    B = params.rho0 * params.c0**2 / params.gamma
    return B * ((rho / params.rho0) ** params.gamma - 1.0)


def _renormalize_density(rho, params):
    """Clipped rest-volume Shepard normalization of summation density,
    whose closed form is the Hughes-Graham floor ``max(rho, rho0)`` (the
    derivation is in ``tpgsd.sph.step._renormalize_density``)."""
    return torch.clamp(rho, min=params.rho0)


def _floor_density(rho, mask, params, density_renorm=False):
    """Floor the summed or carried density of live slots at ``0.1 rho0``,
    renormalize, and fill dead slots (``rho0``, ``p = 0``: keeps
    ``p/rho^2`` finite in the acceleration pass, and gives the pair
    passes the same densities whether or not they floor the neighbour's
    themselves) -> ``(rho, p)``."""
    rho = torch.where(mask, torch.clamp(rho, min=0.1 * params.rho0),
                      params.rho0)
    if density_renorm:
        rho = _renormalize_density(rho, params)
    return rho, torch.where(mask, tait_pressure(rho, params), 0.0)


def _carried_density(rho_cur, drho, dt, params):
    """Continuity's density update ``rho_cur + dt drho``, floored at
    ``0.1 rho0``, and its pressure -> ``(rho, p)``."""
    rho = torch.clamp(rho_cur + dt * drho, min=0.1 * params.rho0)
    return rho, tait_pressure(rho, params)


def _integrate(x, v, acc, dt, params, lo, hi, drift_dv=None,
               wrapped_axes=None, raw=False):
    """Symplectic Euler (kick then drift, ``drift_dv`` added to the drift
    velocity only) and reflective walls with damping (reflect, then
    clip), except the modular wrap on ``wrapped_axes`` -> ``(x, v)``.
    The one copy of this arithmetic, so the global, slab and decomposed
    steps agree bit for bit.  ``raw`` also returns the positions before
    the wrap (walls applied), from which the decomposed step detects a
    crossing of the periodic seam -> ``(x, v, x_raw)``."""
    v_new = (v + dt * acc) * params.velocity_damping
    x_new = x + dt * (v_new if drift_dv is None else v_new + drift_dv)
    under = x_new < lo
    over = x_new > hi
    reflected = torch.where(under, 2.0 * lo - x_new, x_new)
    reflected = torch.where(over, 2.0 * hi - reflected, reflected)
    reflected = torch.clamp(reflected, lo, hi)
    bounce = under | over
    if wrapped_axes is not None:
        x_raw = torch.where(wrapped_axes, x_new, reflected) if raw else None
        wrapped = lo + torch.remainder(x_new - lo, hi - lo)
        x_new = torch.where(wrapped_axes, wrapped, reflected)
        bounce = bounce & ~wrapped_axes
    else:
        x_new = x_raw = reflected
    v_new = torch.where(bounce, -params.wall_damping * v_new, v_new)
    return (x_new, v_new, x_raw) if raw else (x_new, v_new)


#: values per ``[B, K, 27K]`` pair plane of the plain pair passes; bounds
#: their peak memory at about 16 such planes (0.5 GB)
_PAIR_PLANE = 1 << 23


def _cell_blocks(mc):
    """The cells the plain pair passes evaluate, as index tensors in
    blocks: those with a live slot in the centre mask ``mc [C, K]`` (a
    cell without one gives 0)."""
    k = mc.shape[1]
    block = max(1, _PAIR_PLANE // (27 * k * k))
    return torch.split(torch.nonzero(mc.any(dim=1)).squeeze(1), block)


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

    The root comes from ``torch.hypot``, not from an elementwise
    ``torch.sqrt``: on the CPU, float32 ``torch.sqrt`` of a large tensor
    was seen to return values off by up to 3.3e-4 (relative) over one
    worker thread's share of the tensor, at the first calls in some
    processes (ROADMAP "Faults found").  ``torch.linalg.vector_norm``
    over the leading axis avoids that too, but on the CPU it takes about
    300 times as long as two ``hypot`` calls, which are within 1.2e-7
    relative of the float64 norm."""
    return torch.hypot(torch.hypot(d[0], d[1]), d[2])


def _min_image(diff, mimage):
    """Wrap pair separations ``[3, ...]`` to the nearest periodic image.
    ``mimage`` (``[3, 1, 1, 1]``, from :func:`minimum_image`) holds the
    domain extent on wrapped axes and a huge finite sentinel on the
    others (``round(x / huge) == 0`` leaves those components untouched;
    an inf would give ``inf * 0 = NaN``)."""
    if mimage is None:
        return diff
    return diff - mimage * torch.round(diff / mimage)


def _pair_terms(xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel,
                mimage=None):
    """Shared pair machinery of the momentum equation on SoA blocks
    (centres ``[3, B, K, 1]``, neighbours ``[3, B, 1, 27K]``): returns
    ``(dx, dwr, press_plus_pi, vdotx)``."""
    h2eps = params.eps * params.h * params.h
    dx = _min_image(xb - y, mimage)  # [3, B, K, 27K]
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


def _density_blocks(xc, mc, xn, mn, nbr, params, kernel, mimage=None):
    """Plain per-slot density of centre tier ``(xc [3, C, K], mc [C, K])``
    from neighbour tier ``(xn, mn)`` over the 27-cell table ``nbr``
    (``[C, 27]`` int64, sentinel ``C``) -> ``[C, K]``.  A periodic ``nbr``
    comes with its ``mimage`` (:func:`minimum_image`)."""
    c, k = mc.shape
    xn_s = _with_sentinel_cell(xn, 0.0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_zeros((c, k))
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        y = _gather_nbr(xn_s, nb)  # [3, B, 1, 27K]
        ym = _gather_nbr(mn_s, nb)  # [B, 1, 27K]
        r = _distance(_min_image(xc[:, cells, :, None] - y, mimage))
        w = kernel.w(r, params.h, dim=params.dim) * ym
        out[cells] = params.mass * torch.sum(w, dim=-1) * mc[cells]
    return out


def _momentum_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params,
                     kernel, mimage):
    """Cell blocks of the momentum pair pass of centre tier ``c`` from
    neighbour tier ``n``: yields ``(cells, dx, dwr, press_pi, vdotx, ym,
    rhob, rhoy)`` with the :func:`_pair_terms` of the ``cells`` (an index
    tensor, :func:`_cell_blocks`), the neighbours' live mask ``ym [B, 1,
    27K]`` and the centre and neighbour densities."""
    xn_s = _with_sentinel_cell(xn, 0.0)
    vn_s = _with_sentinel_cell(vn, 0.0)
    rhon_s = _with_sentinel_cell(rhon, params.rho0)
    pn_s = _with_sentinel_cell(pn, 0.0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        rhob = rhoc[cells, :, None]
        rhoy = _gather_nbr(rhon_s, nb)
        dx, dwr, press_pi, vdotx = _pair_terms(
            xc[:, cells, :, None], vc[:, cells, :, None],
            rhob, pc[cells, :, None],
            _gather_nbr(xn_s, nb), _gather_nbr(vn_s, nb),
            rhoy, _gather_nbr(pn_s, nb),
            params, kernel, mimage,
        )
        yield cells, dx, dwr, press_pi, vdotx, _gather_nbr(mn_s, nb), rhob, rhoy


def _accel_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params,
                  kernel, mimage=None):
    """Plain per-slot acceleration (pressure + viscosity) of centre tier
    ``c`` from neighbour tier ``n`` -> ``[3, C, K]``.  Dead slots must
    carry a positive density (the step sets ``rho0``, ``p = 0``)."""
    out = xc.new_zeros((3,) + tuple(mc.shape))
    for cells, dx, dwr, press_pi, _, ym, _, _ in _momentum_blocks(
        xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params, kernel,
        mimage,
    ):
        scale = -params.mass * press_pi * dwr * ym
        acc = torch.sum(scale * dx, dim=-1)  # [3, B, K]
        out[:, cells] = acc * mc[cells]
    return out


def _accel_drho_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr,
                       params, kernel, delta_sph, mimage=None):
    """Plain fused momentum + continuity pair pass of centre tier ``c``
    from neighbour tier ``n`` -> ``[4, C, K]`` = acc3 | drho/dt.

    The continuity equation ``drho_i/dt = sum_j m dwr (v_ij . x_ij)``
    shares every pair term of the momentum equation.  ``delta_sph`` adds
    the Molteni-Colagrossi diffusion ``delta h c0 sum_j (2 m / rho_j)
    (rho_i - rho_j) dwr r^2 / (r^2 + eta^2)``, ``eta = 0.1 h``; 0 skips
    the term.  The self pair contributes exactly 0 through ``r^2``.  Dead
    slots must carry a positive density, as in :func:`_accel_blocks`."""
    eta2 = (0.1 * params.h) ** 2
    dcoef = 2.0 * delta_sph * params.h * params.c0 * params.mass
    out = xc.new_zeros((4,) + tuple(mc.shape))
    for cells, dx, dwr, press_pi, vdotx, ym, rhob, rhoy in _momentum_blocks(
        xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params, kernel,
        mimage,
    ):
        scale = -params.mass * press_pi * dwr * ym  # as in _accel_blocks
        acc = torch.sum(scale * dx, dim=-1)  # [3, B, K]
        drho = params.mass * dwr * vdotx
        if delta_sph > 0.0:
            r2 = torch.sum(dx * dx, dim=0)
            drho = drho + dcoef * (rhob - rhoy) / rhoy * dwr * r2 / (r2 + eta2)
        out[:3, cells] = acc * mc[cells]
        out[3, cells] = torch.sum(drho * ym, dim=-1) * mc[cells]
    return out


def _energy_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params,
                   kernel, mimage=None):
    """Plain internal-energy rate ``du_i/dt = 1/2 sum_j m (p_i/rho_i^2 +
    p_j/rho_j^2 + Pi_ij) (v_i - v_j) . grad_W_ij`` of centre tier ``c``
    from neighbour tier ``n`` -> ``[C, K]``: the conjugate of the
    momentum equation, built from the same :func:`_pair_terms`
    (``tpgsd.sph.step._energy_blocks``).  Dead slots as in
    :func:`_accel_blocks`."""
    out = xc.new_zeros(tuple(mc.shape))
    for cells, _, dwr, press_pi, vdotx, ym, _, _ in _momentum_blocks(
        xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params, kernel,
        mimage,
    ):
        du = 0.5 * params.mass * press_pi * dwr * vdotx * ym
        out[cells] = torch.sum(du, dim=-1) * mc[cells]
    return out


def _xsph_blocks(xc, vc, rhoc, mc, xn, vn, rhon, mn, nbr, params, kernel,
                 mimage=None):
    """Plain XSPH drift-velocity correction ``dv_i = sum_j (2 m / (rho_i +
    rho_j)) (v_j - v_i) W_ij`` of centre tier ``c`` from neighbour tier
    ``n`` -> ``[3, C, K]`` (``tpgsd.sph.step._xsph_blocks``; note the
    sign, ``v_j - v_i``).  The pair weight is symmetric and the velocity
    difference antisymmetric, so the correction carries no momentum."""
    c, k = mc.shape
    xn_s = _with_sentinel_cell(xn, 0.0)
    vn_s = _with_sentinel_cell(vn, 0.0)
    rhon_s = _with_sentinel_cell(rhon, params.rho0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_zeros((3, c, k))
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        dx = _min_image(xc[:, cells, :, None] - _gather_nbr(xn_s, nb), mimage)
        w = kernel.w(_distance(dx), params.h, dim=params.dim)
        coef = (
            2.0 * params.mass / (rhoc[cells, :, None] + _gather_nbr(rhon_s, nb))
        ) * w * _gather_nbr(mn_s, nb)
        dv = _gather_nbr(vn_s, nb) - vc[:, cells, :, None]
        out[:, cells] = torch.sum(coef * dv, dim=-1) * mc[cells]
    return out


def _cohesion_c(r, hs):
    """Akinci et al. (2013) cohesion spline ``C(r)`` at support ``hs``
    with its 3-D normalisation ``32/(pi hs^9)`` (used in 2-D too), as in
    ``tpgsd.sph.step._cohesion_c``: attractive over ``hs/2 < r <= hs``,
    repulsive below about ``hs/4``."""
    c = 32.0 / (np.pi * hs**9)
    hr = torch.clamp(hs - r, min=0.0)
    core = hr**3 * r**3
    outer = torch.where(r <= hs, core, 0.0)
    inner = 2.0 * core - hs**6 / 64.0
    return c * torch.where(r > 0.5 * hs, outer, inner)


def _st_normals_blocks(xc, mc, xn, rhon, mn, nbr, params, kernel, mimage=None):
    """Plain Akinci surface normals ``n_i = hs sum_j (m / rho_j) dW/dr / r
    (x_i - x_j)`` (``hs`` the kernel support) of centre tier ``c`` from
    neighbour tier ``n`` -> ``[3, C, K]``
    (``tpgsd.sph.step._st_normals_blocks``).  Dead neighbour slots must
    carry a positive density."""
    c, k = mc.shape
    hs = kernel.support_scale * params.h
    xn_s = _with_sentinel_cell(xn, 0.0)
    rhon_s = _with_sentinel_cell(rhon, params.rho0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_zeros((3, c, k))
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        dx = _min_image(xc[:, cells, :, None] - _gather_nbr(xn_s, nb), mimage)
        dwr = kernel.dw_over_r(_distance(dx), params.h, dim=params.dim)
        coef = (params.mass / _gather_nbr(rhon_s, nb)) * dwr * _gather_nbr(mn_s, nb)
        out[:, cells] = hs * torch.sum(coef * dx, dim=-1) * mc[cells]
    return out


def _st_force_blocks(xc, nc, rhoc, mc, xn, nn, rhon, mn, nbr, params, kernel,
                     gamma, mimage=None):
    """Plain Akinci surface-tension acceleration ``a_i = -gamma sum_j
    K_ij [m C(r) (x_i - x_j) / max(r, 1e-12) + (n_i - n_j)]`` with
    ``K_ij = 2 rho0 / (rho_i + rho_j)``, of centre tier ``c`` (normals
    ``nc [3, C, K]``) from neighbour tier ``n`` -> ``[3, C, K]``
    (``tpgsd.sph.step._st_force_blocks``).  The curvature term carries no
    kernel weight, so, as in the reference, it sums over every live slot
    of the 27 cells, within the support or not.  The self pair adds
    exactly 0 (``x_i - x_i = 0``, ``n_i - n_i = 0``)."""
    c, k = mc.shape
    hs = kernel.support_scale * params.h
    xn_s = _with_sentinel_cell(xn, 0.0)
    nn_s = _with_sentinel_cell(nn, 0.0)
    rhon_s = _with_sentinel_cell(rhon, params.rho0)
    mn_s = _with_sentinel_cell(mn.to(xn.dtype), 0.0)
    out = xc.new_zeros((3, c, k))
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        dx = _min_image(xc[:, cells, :, None] - _gather_nbr(xn_s, nb), mimage)
        r = _distance(dx)
        kij = (
            2.0 * params.rho0 / (rhoc[cells, :, None] + _gather_nbr(rhon_s, nb))
        ) * _gather_nbr(mn_s, nb)
        coh = (-gamma * params.mass * kij * _cohesion_c(r, hs)
               / torch.clamp(r, min=1e-12))
        acc = torch.sum(coh * dx, dim=-1)
        dn = nc[:, cells, :, None] - _gather_nbr(nn_s, nb)
        acc = acc + torch.sum(-gamma * kij * dn, dim=-1)
        out[:, cells] = acc * mc[cells]
    return out


@functools.lru_cache(maxsize=8)
def neighbor_index(grid, device, periodic=False):
    """The ``[C, 27]`` neighbour table as an int64 tensor on ``device``
    (cached per grid, device and ``periodic``, which is ``False``,
    ``True`` or a 3-tuple of bools; callers must not write to it)."""
    table = neighbor_table(grid, periodic=periodic)
    return torch.from_numpy(table.astype(np.int64)).to(device)


@functools.lru_cache(maxsize=8)
def minimum_image(grid, device, periodic):
    """``[3, 1, 1, 1]`` minimum-image extents of ``grid`` on ``device``
    for the plain pair passes (``None`` when nothing wraps): the domain
    extent on the axes :func:`~tpgsd_torch.sph.cells.wrap_axes` selects,
    1e30 on the others.  Cached like :func:`neighbor_index`."""
    wrap = wrap_axes(grid, periodic)
    if not wrap.any():
        return None
    ext = grid.cell_size * np.asarray(grid.dims, np.float32)
    m = np.where(wrap, ext, np.float32(1e30)).astype(np.float32)
    return torch.from_numpy(m).to(device)[:, None, None, None]


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

    On CUDA, ``"auto"`` means the kernels: a capacity past what they
    take (:func:`ops.supported`) raises ``ValueError`` naming the limit
    instead of running the plain pair passes on the card.  Only an
    explicit ``use_kernels=False`` runs the plain passes there.
    Elsewhere ``"auto"`` is the plain path.  ``spill="auto"`` is the
    two-tier layout exactly where the kernels run and take the capacity
    as a tier (:func:`ops.spill_supported`, K <= 64); a larger capacity
    is the single tier of the wide kernels, and ``spill=True`` with the
    kernels raises ``ValueError`` there."""
    from .ops import MAX_CAPACITY, MAX_WIDE_CAPACITY, spill_supported, supported

    on_cuda = device_type == "cuda"
    if use_kernels == "auto":
        use_kernels = on_cuda
    if use_kernels:
        if not on_cuda:
            raise ValueError(
                "use_kernels=True needs a CUDA device; got %s" % (device_type,)
            )
        if not supported(grid):
            raise ValueError(
                "the CUDA pair kernels take 1 <= capacity <= %d; got %d "
                "(use_kernels=False runs the plain pair passes)"
                % (MAX_WIDE_CAPACITY, grid.capacity)
            )
    if spill == "auto":
        spill = bool(use_kernels) and spill_supported(grid)
    if spill and use_kernels and not spill_supported(grid):
        raise ValueError(
            "the two-tier spill kernels take 1 <= capacity <= %d; got %d "
            "(a larger capacity runs single-tier: spill=False)"
            % (MAX_CAPACITY, grid.capacity)
        )
    return bool(use_kernels), bool(spill)


@torch.inference_mode()
def density_and_pressure(x, grid, params, kernel=WendlandC2, periodic=False,
                         density_renorm=False, device="cuda"):
    """Standalone summation density + Tait pressure of a configuration:
    per-particle ``(rho, p)``, the quantities of the schema's
    ``particles/density`` / ``particles/pressure`` chunks.

    The pair pass follows the step's ``"auto"`` policy
    (:func:`resolve_policy`): on a CUDA ``device`` the two-tier spill
    layout through the ``density_pairs`` kernel for capacities up to 64
    and the single tier through the wide kernel past it; on the CPU the
    single-tier plain pass.  ``periodic`` wraps the axes with at least 3
    cells.  Particles past the layout's capacity get ``rho0``.
    """
    from . import ops  # ops imports this module's plain pair passes

    dev = _resolve_device(device)
    if x.device != dev:
        raise ValueError(
            "density_and_pressure on %s got positions on %s" % (dev, x.device)
        )
    use_kernels, spill = resolve_policy(dev.type, grid)
    wrap = _wrap_tuple(grid, periodic)
    c, k = grid.n_cells, grid.capacity
    if spill:
        cells, sp = build_cells_spill(x, grid, k)
        x_a = scatter_to_cells_soa(x, cells, grid)
        x_b = scatter_to_cells_soa(x, cells, grid, slot_base=k, capacity=k)
        tiers = zip(ops.density_spill(
            x_a, cells.mask, x_b, sp.mask, grid, params, kernel=kernel,
            wrap_axes=wrap,
        ), (cells.mask[:c], sp.mask[:c]))
    else:
        cells = build_cells(x, grid)
        dense_x = scatter_to_cells_soa(x, cells, grid)
        mask = cells.mask[:c]
        if use_kernels:
            rho_dense = ops.density(
                dense_x, mask, grid, params, kernel=kernel, wrap_axes=wrap
            )
        else:
            rho_dense = _density_blocks(
                dense_x, mask, dense_x, mask,
                neighbor_index(grid, dev, bool(periodic)), params, kernel,
                minimum_image(grid, dev, bool(periodic)),
            )
        tiers = ((rho_dense, mask),)
    if density_renorm:
        tiers = [(torch.where(m, _renormalize_density(r, params), r), m)
                 for r, m in tiers]
    rho = ops.slot_rows([[r] for r, _ in tiers], (float(params.rho0),),
                        cells, grid.dims, plain=not use_kernels)[:, 0]
    rho = torch.clamp(rho, min=0.1 * params.rho0)  # isolated-particle floor
    return rho, tait_pressure(rho, params)


def init_density(state, grid, params, kernel=WendlandC2, periodic=False,
                 rho=None, device="cuda"):
    """Seed ``state.rho`` for continuity-density mode.

    By default the seed is the summation density of the configuration
    (:func:`density_and_pressure`; ``periodic`` as there).  Pass ``rho``
    (a scalar or ``[N]`` values) to override - e.g. ``rho0`` everywhere
    for a pre-relaxed state, or the ``particles/density`` chunk when
    resuming from a trajectory.
    """
    if rho is None:
        rho, _ = density_and_pressure(
            state.x, grid, params, kernel=kernel, periodic=periodic,
            device=device,
        )
    else:
        dev = _resolve_device(device)
        rho = torch.as_tensor(rho, dtype=torch.float32, device=dev)
        rho = rho.expand(state.x.shape[0]).contiguous()
    return state._replace(rho=rho)


@torch.inference_mode()
def energy_rate(state, grid, params, kernel=WendlandC2, periodic=False,
                device="cuda"):
    """Per-particle internal-energy rate du/dt (``[N]`` float32) of a
    configuration, the physics behind the schema's ``particles/energy``
    chunk (``tpgsd.sph.step.energy_rate``): the WCSPH energy equation,
    the pressure-work and viscous-heating conjugate of the momentum
    equation.  Integrate it beside the step (``u += dt * du``) or dump
    the rate.

    It runs on the single tier at ``grid.capacity`` (never the spill
    layout): summation density without renormalisation, floored at
    ``0.1 rho0``, with ``rho0`` and ``p = 0`` in dead slots, then the
    energy pass.  On a CUDA ``device`` the density goes through
    :func:`ops.density` and the energy through the energy instance of
    the momentum kernel (:func:`ops.energy`; periodic axes as a ghost
    halo); on the CPU both are the plain passes over the wrapped table.
    Particles past the capacity get 0.
    """
    from . import ops  # ops imports this module's plain pair passes

    dev = _resolve_device(device)
    if state.x.device != dev:
        raise ValueError(
            "energy_rate on %s got a state on %s" % (dev, state.x.device)
        )
    use_kernels, _ = resolve_policy(dev.type, grid, spill=False)
    c = grid.n_cells
    cells = build_cells(state.x, grid)
    xv = scatter_to_cells_soa(torch.cat([state.x, state.v], dim=-1), cells,
                              grid)
    m = cells.mask[:c]
    if use_kernels:
        wrap = _wrap_tuple(grid, periodic)
        rho = ops.density(xv[:3], m, grid, params, kernel=kernel,
                          wrap_axes=wrap)
    else:
        nbr = neighbor_index(grid, dev, bool(periodic))
        mimage = minimum_image(grid, dev, bool(periodic))
        rho = _density_blocks(xv[:3], m, xv[:3], m, nbr, params, kernel,
                              mimage)
    rho, p = _floor_density(rho, m, params)
    if use_kernels:
        du = ops.energy(xv[:3], xv[3:], rho, p, m, grid, params,
                        kernel=kernel, wrap_axes=wrap)
    else:
        du = _energy_blocks(xv[:3], xv[3:], rho, p, m, xv[:3], xv[3:], rho,
                            p, m, nbr, params, kernel, mimage)
    return ops.slot_rows([[du]], (0.0,), cells, grid.dims,
                         plain=not use_kernels)[:, 0]


def _wrap_tuple(grid, periodic):
    """The axes that wrap as the 3-tuple of bools the pair ops take as
    ``wrap_axes`` (``None`` when nothing wraps)."""
    wrap = tuple(map(bool, wrap_axes(grid, bool(periodic))))
    return wrap if any(wrap) else None


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
    delta_sph=0.1,
    sharding=None,
    device="cuda",
    _traced_dt=False,
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
            pair passes elsewhere; on CUDA a capacity the kernels do not
            take raises (see :func:`resolve_policy`).
        n_fixed: the first ``n_fixed`` particles are static boundary
            particles: SPH sources that never move.
        periodic: wrap every axis with at least 3 cells instead of
            reflecting at its walls (fewer cells would make a cell its
            own neighbour through the seam; the collapsed z axis of a 2-D
            scenario stays closed).  The kernels see the wrap as a ghost-
            cell halo, the plain passes as a wrapped neighbour table and
            minimum-image separations.
        density_renorm: floor summation density at ``rho0`` (the clipped
            Shepard renormalization).
        spill: two-tier cell layout: ``grid.capacity`` sizes the main
            tier and an equal spill tier holds the excess of denser
            cells.  ``"auto"`` turns it on exactly when the kernels run
            at a capacity up to 64; past it they run single-tier (the
            wide kernels).  ``spill=True`` without kernels runs the plain
            versions of the spill ops (any device).
        density_mode: ``"summation"`` re-sums density from positions
            every step.  ``"continuity"`` evolves ``state.rho`` (seed it
            with :func:`init_density`) by the continuity equation, whose
            pair terms fuse into the momentum pass: one neighbour sweep
            per step instead of two, through the ``accel_drho`` kernels
            on the card.  It excludes ``density_renorm``.
        delta_sph: delta-SPH density-diffusion strength (continuity mode
            only; 0.1 is the standard setting, 0 = off).
        xsph: XSPH drift-velocity smoothing strength (Monaghan's
            epsilon, typically 0.5; 0 = off): particles drift with ``v +
            xsph * dv`` (the kick is unchanged).  On the card its three
            sums ride the momentum kernel's launch (launch keys
            ``accel_xsph`` and ``accel_drho_xsph``).
        surface_tension: strength gamma of the Akinci surface-tension
            model (cohesion and curvature; 0 = off): a normals pass, then
            a force pass added to the acceleration (the ``st_normals``
            and ``st_force`` kernels on the card).
        sharding: not ported; raises ``NotImplementedError`` naming its
            ROADMAP item.
        device: the device of the states the step takes (the card unless
            the caller asks for ``"cpu"``).

    The returned function carries ``resolved = {"use_kernels", "spill",
    "density_mode"}``.

    The step is ``step(state, dt=params.dt)``: ``dt`` may be a 0-d
    float32 tensor on ``device`` (the same arithmetic as the float, so
    ``dt == params.dt`` gives the same bits).  The private
    ``_traced_dt=True`` (:func:`make_adaptive_step_fn`) makes it return
    ``(state, aux, a2max)``, ``a2max`` the 0-d max of ``|a|^2`` over the
    mobile particles (gravity included), the controller's force input.
    """
    from . import ops  # ops imports this module's plain pair passes

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
    if sharding is not None:
        raise _not_ported("the GSPMD sharding hint", 9)

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
    cell_bounds(grid, dev, torch.float32)  # made now, not in the step
    periodic = bool(periodic)
    wrap = _wrap_tuple(grid, periodic)  # the ops' ghost-halo axes
    wrapped_axes = torch.from_numpy(wrap_axes(grid, periodic)).to(dev)

    def _finish(x, v, out, overflow, dt, rho_cur=None):
        """Integrate/boundary tail: ``out`` holds the per-particle rows
        [acc3 | (xsph dv3) | rho | p] (summation mode) or [acc3 | drho |
        (xsph dv3)] (continuity mode, with the prior density as
        ``rho_cur``); ``dt`` is ``params.dt`` or a 0-d device tensor."""
        acc = out[:, :3] + gravity
        if continuity:
            # dropped particles read drho = 0 (the fill row) and keep
            # their carried density
            rho, p = _carried_density(rho_cur, out[:, 3], dt, params)
        else:
            rho = out[:, -2]
            p = out[:, -1]
        drift_dv = None
        if xsph > 0:
            # XSPH smooths the drift velocity only; the kick and the
            # bounce keep v_new
            drift_dv = xsph * (out[:, 4:7] if continuity else out[:, 3:6])
        x_new, v_new = _integrate(x, v, acc, dt, params, lo, hi, drift_dv,
                                  wrapped_axes if periodic else None)

        if n_fixed > 0:
            # boundary particles never move; in continuity mode their
            # density still evolves (the dummy-particle treatment)
            x_new = torch.cat([x[:n_fixed], x_new[n_fixed:]])
            v_new = torch.cat([v.new_zeros((n_fixed, 3)), v_new[n_fixed:]])
        state = SPHState(x=x_new, v=v_new, rho=rho if continuity else None)
        if _traced_dt:
            # the mobile particles' largest |a|^2: fixed boundary slots
            # never move, so they cannot limit the step
            a2 = torch.sum(acc * acc, dim=-1)
            return state, (rho, p, overflow), torch.amax(a2[n_fixed:])
        return state, (rho, p, overflow)

    def finish_rho(rho, mask):
        """:func:`_floor_density` of the summed or carried density on the
        real cells of ``mask``."""
        return _floor_density(rho, mask[:c], params, density_renorm)

    # the fill row of a dropped particle: zero acc, p, drho and XSPH
    # correction (it keeps its carried density), rho0
    n_cols = (4 if continuity else 5) + 3 * (xsph > 0)
    fill = (0.0,) * n_cols if continuity else (0.0,) * (n_cols - 2) + (
        float(params.rho0), 0.0)

    def to_particles(tiers, cells):
        """Each particle's row of the per-slot results (:func:`ops.
        slot_rows`), one column source list a tier: [acc3 | (xsph dv3) |
        rho | p], or the momentum pass's [acc3 | drho | (xsph dv3)] in
        continuity mode; inside the ``step.rows`` range."""
        with phase("step.rows"):
            return ops.slot_rows(tiers, fill, cells, grid.dims,
                                 plain=not use_kernels)

    def _check(state):
        if state.x.device != dev:
            raise ValueError(
                "step built for %s got a state on %s" % (dev, state.x.device)
            )
        if continuity and state.rho is None:
            raise ValueError(
                "density_mode='continuity' needs state.rho - seed it with "
                "tpgsd_torch.sph.init_density(state, grid, params)"
            )

    # the kernels (the ghost halo for ``wrap``) or the plain passes (the
    # wrapped table and minimum image), on the layout and mode
    pairs = ops.pair_ops(use_kernels, spill, continuity)
    phase = get_tracer().range

    def step_fn(body):
        """The step of ``body(state, dt)``: the state checked, under
        ``torch.inference_mode()``, inside the ``step`` range whose
        children the body opens (``step.cells``, ``step.density``,
        ``step.momentum``, ``step.surface_tension``, ``step.finish`` with
        ``step.rows`` inside it)."""

        @torch.inference_mode()
        def run(state, dt=params.dt):
            _check(state)
            with phase("step"):
                return body(state, dt)

        run.resolved = resolved
        return run

    if spill and continuity:

        @step_fn
        def step_continuity_spill(state, dt):
            x, v, rho = state.x, state.v, state.rho
            with phase("step.cells"):
                cells, sp = build_cells_spill(x, grid, k)
                # one fused 7-column layout gather per tier (x | v | rho)
                xvr = torch.cat([x, v, rho[:, None]], dim=-1)
                soa_a = scatter_to_cells_soa(xvr, cells, grid)
                soa_b = scatter_to_cells_soa(xvr, cells, grid, slot_base=k,
                                             capacity=k)
            with phase("step.density"):  # the carried density's pressure
                rho_a, p_a = finish_rho(soa_a[6], cells.mask)
                rho_b, p_b = finish_rho(soa_b[6], sp.mask)
            with phase("step.momentum"):
                out_a, out_b = pairs.momentum(
                    soa_a[:3], soa_a[3:6], rho_a, p_a, cells.mask,
                    soa_b[:3], soa_b[3:6], rho_b, p_b, sp.mask,
                    grid, params, kernel=kernel, delta_sph=delta_sph,
                    wrap_axes=wrap, xsph=xsph > 0,
                )  # [C, K, 4 (+3 xsph)]
            if surface_tension > 0:
                with phase("step.surface_tension"):
                    st_a, st_b = pairs.surface_tension(
                        soa_a[:3], rho_a, cells.mask, soa_b[:3], rho_b,
                        sp.mask, grid, params, surface_tension,
                        kernel=kernel, wrap_axes=wrap,
                    )
                    # added in place to the acceleration columns
                    out_a[..., :3] += st_a
                    out_b[..., :3] += st_b
            with phase("step.finish"):
                out = to_particles([[out_a], [out_b]], cells)
                return _finish(x, v, out, cells.overflow, dt, rho_cur=rho)

        return step_continuity_spill

    if spill:

        @step_fn
        def step_spill(state, dt):
            x, v = state.x, state.v
            with phase("step.cells"):
                cells, sp = build_cells_spill(x, grid, k)
                xv = torch.cat([x, v], dim=-1)
                soa_a = scatter_to_cells_soa(xv, cells, grid)
                soa_b = scatter_to_cells_soa(xv, cells, grid, slot_base=k,
                                             capacity=k)
            with phase("step.density"):
                rho_a, rho_b = pairs.density(
                    soa_a[:3], cells.mask, soa_b[:3], sp.mask, grid, params,
                    kernel=kernel, wrap_axes=wrap,
                )
                rho_a, p_a = finish_rho(rho_a, cells.mask)
                rho_b, p_b = finish_rho(rho_b, sp.mask)
            with phase("step.momentum"):
                acc_a, acc_b = pairs.momentum(
                    soa_a[:3], soa_a[3:], rho_a, p_a, cells.mask,
                    soa_b[:3], soa_b[3:], rho_b, p_b, sp.mask,
                    grid, params, kernel=kernel, wrap_axes=wrap,
                    xsph=xsph > 0,
                )
            if surface_tension > 0:
                with phase("step.surface_tension"):
                    st_a, st_b = pairs.surface_tension(
                        soa_a[:3], rho_a, cells.mask, soa_b[:3], rho_b,
                        sp.mask, grid, params, surface_tension,
                        kernel=kernel, wrap_axes=wrap,
                    )
                    acc_a[..., :3] += st_a
                    acc_b[..., :3] += st_b
            with phase("step.finish"):
                out = to_particles([[acc_a, rho_a, p_a], [acc_b, rho_b, p_b]],
                                   cells)
                return _finish(x, v, out, cells.overflow, dt)

        return step_spill

    # single tier: the kernels (the self role up to K = 64, the wide
    # kernels past it); the momentum pass returns [3 or 4 (+3 xsph), C, K]
    mom_kw = {"delta_sph": delta_sph} if continuity else {}

    def density(dense_x, m):
        return pairs.density(dense_x, m, grid, params, kernel=kernel,
                             wrap_axes=wrap)

    def momentum(dense_x, dense_v, rho, p, m):
        return pairs.momentum(dense_x, dense_v, rho, p, m, grid, params,
                              kernel=kernel, wrap_axes=wrap, xsph=xsph > 0,
                              **mom_kw)

    def surface_tension_pass(dense_x, rho, m):
        return pairs.surface_tension(dense_x, rho, m, grid, params,
                                     surface_tension, kernel=kernel,
                                     wrap_axes=wrap)

    if continuity:

        @step_fn
        def step_continuity(state, dt):
            x, v, rho = state.x, state.v, state.rho
            with phase("step.cells"):
                cells = build_cells(x, grid)
                xvr = scatter_to_cells_soa(
                    torch.cat([x, v, rho[:, None]], dim=-1), cells, grid
                )
                m = cells.mask[:c]
            with phase("step.density"):  # the carried density's pressure
                rho_d, p_d = finish_rho(xvr[6], cells.mask)
            with phase("step.momentum"):
                out4 = momentum(xvr[:3], xvr[3:6], rho_d, p_d, m)
            if surface_tension > 0:
                with phase("step.surface_tension"):
                    out4[:3] += surface_tension_pass(xvr[:3], rho_d, m)
            with phase("step.finish"):
                out = to_particles([[out4.permute(1, 2, 0)]], cells)
                return _finish(x, v, out, cells.overflow, dt, rho_cur=rho)

        return step_continuity

    @step_fn
    def step(state, dt):
        x, v = state.x, state.v
        with phase("step.cells"):
            cells = build_cells(x, grid)
            xv = scatter_to_cells_soa(torch.cat([x, v], dim=-1), cells, grid)
            dense_x, dense_v = xv[:3], xv[3:]
            m = cells.mask[:c]
        with phase("step.density"):
            rho, p = finish_rho(density(dense_x, m), cells.mask)
        with phase("step.momentum"):
            acc = momentum(dense_x, dense_v, rho, p, m)
        if surface_tension > 0:
            with phase("step.surface_tension"):
                acc[:3] += surface_tension_pass(dense_x, rho, m)
        with phase("step.finish"):
            out = to_particles([[acc.permute(1, 2, 0), rho, p]], cells)
            return _finish(x, v, out, cells.overflow, dt)

    return step


def _cfl_dt(a2max, v2max, params, cfl, dt_min, dt_max):
    """The CFL controller's next dt (0-d, on the device of its inputs)
    from the step's largest ``|a|^2`` of the mobile particles and
    ``|v|^2`` of the new state: :func:`make_adaptive_step_fn`'s rule,
    device arithmetic only."""
    h = float(params.h)
    amax = torch.sqrt(torch.clamp(a2max, min=1e-30))
    vmax = torch.sqrt(torch.clamp(v2max, min=1e-30))
    dt_f = torch.sqrt(torch.div(h, amax))
    dt_cv = torch.div(h, float(params.c0) + vmax)
    return torch.clamp(cfl * torch.minimum(dt_f, dt_cv), min=dt_min,
                       max=dt_max)


def state_device(state):
    """The device of a state's positions: of the first shard for a
    decomposed state, whose fields hold one tensor a shard."""
    x = state.x
    return (x[0] if isinstance(x, (tuple, list)) else x).device


def make_adaptive_step_fn(grid, params, cfl=0.25, dt_min=0.0, dt_max=None,
                          **kwargs):
    """Build a CFL-adaptive variant of the SPH step
    (``tpgsd.sph.step.make_adaptive_step_fn``).

    Each step advances by the ``dt`` it is given and returns the
    controller's choice for the next one (Monaghan 1992)::

        dt_f  = sqrt(h / max_i |a_i|)          # force condition
        dt_cv = h / (c0 + max_i |v_i|)         # Courant + advection
        dt    = clamp(cfl * min(dt_f, dt_cv), dt_min, dt_max)

    ``max |a|`` is over the mobile particles of the step just taken and
    ``max |v|`` over the new state, with the reference's ``1e-30`` floors
    under both square roots.  ``dt`` and ``dt_next`` are 0-d float32
    tensors on the step's device and the controller is device
    arithmetic: choosing ``dt`` never waits for the card, so a rollout
    (:func:`run_adaptive`) queues step after step without a host sync.

    Args:
        grid / params: as :func:`make_step_fn`; ``params.dt`` seeds a
            rollout and, by default, caps ``dt_next``.
        cfl: safety factor on the CFL minimum.
        dt_min: floor on ``dt_next`` (0 = none).
        dt_max: ceiling on ``dt_next`` (default ``params.dt``).
        **kwargs: forwarded to :func:`make_step_fn` (``n_fixed``,
            ``periodic``, ``xsph``, ``density_mode``, ``spill``,
            ``device``, ...).

    Returns:
        ``step(state, dt) -> (state, (rho, p, overflow), dt_next)``,
        carrying ``resolved`` as :func:`make_step_fn`'s step does.
    """
    base = make_step_fn(grid, params, _traced_dt=True, **kwargs)
    if dt_max is None:
        dt_max = float(params.dt)

    @torch.inference_mode()
    def step(state, dt):
        new_state, aux, a2max = base(state, dt)
        v2max = torch.amax(torch.sum(new_state.v * new_state.v, dim=-1))
        return new_state, aux, _cfl_dt(a2max, v2max, params, cfl, dt_min,
                                       dt_max)

    step.resolved = base.resolved
    return step


def initial_dt(dt0, device):
    """``dt0`` as the 0-d float32 tensor on ``device`` that starts an
    adaptive rollout, and the rollout's time so far, ``0`` (a tensor
    ``dt0`` is taken as it is, moved if it lies elsewhere).  Made by fill
    kernels, not host-to-device copies, so neither waits for the card."""
    if isinstance(dt0, torch.Tensor):
        dt = dt0.to(device=device, dtype=torch.float32)
    else:
        dt = torch.full((), dt0, dtype=torch.float32, device=device)
    return dt, torch.zeros((), dtype=torch.float32, device=device)


@torch.inference_mode()
def run_adaptive(step_fn, state, dt0, n_steps):
    """Roll an adaptive step out for ``n_steps`` steps
    (``tpgsd.sph.step.run_adaptive``; there a ``lax.scan``, here an eager
    loop).

    The carry ``(state, dt, t)`` stays on the device: step ``i`` advances
    by the carry's ``dt`` and the controller's ``dt_next`` becomes step
    ``i + 1``'s.  Nothing in the loop reads a device value on the host.

    Args:
        step_fn: from :func:`make_adaptive_step_fn` (or
            :func:`tpgsd_torch.sph.make_adaptive_distributed_step_fn`).
        state: initial :class:`SPHState` (or ``DistState``).
        dt0: the first step's dt (e.g. ``params.dt``; a float or a 0-d
            tensor, such as a ``dt_next`` kept from an earlier rollout).
        n_steps: number of steps.

    Returns:
        ``(state, dt_next, t)``: the final state, the controller's next
        dt and the simulated time, the float32 sum of the dts taken
        (both 0-d device tensors).
    """
    dt, t = initial_dt(dt0, state_device(state))
    for _ in range(int(n_steps)):
        state, _aux, dt_next = step_fn(state, dt)
        t = t + dt
        dt = dt_next
    return state, dt, t
