"""Pair passes of the SPH step: hand-written CUDA kernels and their plain
versions (torch counterpart of the entry points of
``tpgsd.sph.pallas_ops``).

The CUDA kernels (``tpgsd_torch/csrc/sph_pairs.cu``) replace the nine
Pallas kernels of the step (summation and continuity density mode):

========================  ==============================================
wrapper (role)            replaces (tpgsd/sph/pallas_ops.py)
========================  ==============================================
density_pairs (self)      ``_density_kernel_packed`` (AA and BB passes)
density_pairs (cross)     ``_density_kernel_packed_cross`` (AB and BA)
accel_pairs (self)        ``_accel_kernel_packed`` (AA and BB)
accel_pairs (cross)       ``_accel_kernel_packed_cross`` (AB and BA)
accel_drho_pairs (self)   ``_accel_drho_kernel_packed`` (AA and BB)
accel_drho_pairs (cross)  ``_accel_drho_kernel_packed_cross`` (AB and BA)
density (wide)            ``_density_kernel`` (single tier, K > 64)
accel (wide)              ``_accel_kernel`` (single tier, K > 64)
accel_drho (wide)         ``_accel_drho_kernel`` (single tier, K > 64)
========================  ==============================================

Four more pair passes run jnp code in the reference (``tpgsd/sph/step.py``),
not Pallas kernels; on the card each is a CUDA kernel on the same tile
walk, with self, cross and wide roles like the nine above:

=============================  =========================================
wrapper (launch-count family)  reference pass (tpgsd/sph/step.py)
=============================  =========================================
``accel(_drho)(xsph=True)``    ``_xsph_blocks``: 3 more sums of the
(``accel_xsph``,               momentum kernel, so XSPH adds no launch
``accel_drho_xsph``)
st_normals_pairs               ``_st_normals_blocks``
(``st_normals``)
st_force_pairs (``st_force``)  ``_st_force_blocks`` (``_cohesion_c``)
energy_pairs (``energy``)      ``_energy_blocks``: the energy output of
                               the momentum kernel, on the very pair
                               scale that the acceleration sums
=============================  =========================================

A self pass and a cross pass differ only in which tier holds the centres
and which the neighbours, so each wrapper takes both tiers explicitly.
The single-tier entry points :func:`density`, :func:`accel` and
:func:`accel_drho` dispatch as the reference does: up to 64 slots per
cell they launch the two-tier kernels in their self role.  Past it they
launch the wide instances of the same tile kernels (counted as
``density_wide``, ``accel_wide`` and ``accel_drho_wide``), whose staging
buffer is sized by a live-slot budget, not by K, and whose centre list
is a ring.
What bounds the kernels on the H100 is the pair arithmetic in the self
roles and the bytes of masks and zeros in the cross roles; the design is
described at the top of the CUDA source.

Periodic axes (``wrap_axes``) reach every kernel as a pre-shifted ghost-
cell halo: the dense layout grows one ghost layer per wrapped axis, each
ghost cell a copy of its periodic image with positions shifted by the
domain extent, the unchanged kernels run on the ghost grid, and the
interior rows are selected back.  The plain versions take the wrapped
neighbour table and minimum-image separations instead, so the two routes
are independent.

Dispatch rule: a tensor on the CPU takes the plain version; a CUDA
tensor launches the kernel or raises.  There is no fallback.  Each
wrapper adds one to :data:`launch_counts` where it launches its kernel.

The finish of every step takes the pair passes' per-slot results to
particle rows through :func:`slot_rows` (:func:`window_rows` a slab of
the slab step): one launch of ``slot_rows_kernel``
(``tpgsd_torch/csrc/slot_rows.cu``) on the card, counted apart from the
pair kernels in :data:`row_launch_counts`, and :func:`slot_rows_plain`,
the same copies as torch operations, on the CPU and in a step built
with ``use_kernels=False``.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .kernels import WendlandC2, kernel_code
from .step import (
    _accel_blocks,
    _accel_drho_blocks,
    _density_blocks,
    _energy_blocks,
    _st_force_blocks,
    _st_normals_blocks,
    _xsph_blocks,
    minimum_image,
    neighbor_index,
)

#: slots per cell the two-tier kernels take
MAX_CAPACITY = 64
#: cells per tile (one CTA of 128 threads) the tile kernels take
MAX_TILE = 16
#: slots per cell the single-tier kernels take past :data:`MAX_CAPACITY`
#: (the wide instances of the tile kernels); a cell list this wide would
#: better be a finer grid
MAX_WIDE_CAPACITY = 1024

#: kernel launches per role since the last :func:`reset_launch_counts`
launch_counts = {
    "density_self": 0,
    "density_cross": 0,
    "accel_self": 0,
    "accel_cross": 0,
    "accel_drho_self": 0,
    "accel_drho_cross": 0,
    "density_wide": 0,
    "accel_wide": 0,
    "accel_drho_wide": 0,
}
#: the pair passes the reference runs in jnp, in the same roles
launch_counts.update({
    "%s_%s" % (family, role): 0
    for family in ("accel_xsph", "accel_drho_xsph", "st_normals", "st_force",
                   "energy")
    for role in ("self", "cross", "wide")
})


#: launches of ``slot_rows_kernel`` since the last
#: :func:`reset_launch_counts`: one a finish of the global step, a slab of
#: the slab step and a shard of a decomposed step
row_launch_counts = {"slot_rows": 0}


def reset_launch_counts():
    for counts in (launch_counts, row_launch_counts):
        for key in counts:
            counts[key] = 0


def supported(grid):
    """True when some CUDA pair kernel takes ``grid.capacity`` slots per
    cell: the two-tier kernels up to :data:`MAX_CAPACITY`, the
    single-tier kernels past it."""
    return 1 <= grid.capacity <= MAX_WIDE_CAPACITY


def spill_supported(grid):
    """True when the two-tier spill path applies: both tiers have
    ``grid.capacity`` slots per cell, which the two-tier kernels take up
    to :data:`MAX_CAPACITY`."""
    return 1 <= grid.capacity <= MAX_CAPACITY


def accel_drho_supported(grid):
    """True when a fused momentum + continuity kernel takes
    ``grid.capacity`` (the same capacities as the other pair kernels)."""
    return supported(grid)


def tile_cells(grid, params):
    """T, the cells of one tile of the tile kernels: as many as a
    fluid at rest fills with at most 128 live centres, so that one round
    of the CTA's 128 threads serves a typical tile.  A cell of side ``s``
    holds ``rho0 s^dim / mass`` particles at rest (at most K); nothing is
    read back from the device.  Any T gives the same results."""
    per_cell = min(
        grid.capacity, params.rho0 * grid.cell_size ** params.dim / params.mass
    )
    return int(max(1, min(MAX_TILE, 128 // max(per_cell, 1.0))))


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _wrapped(wrap_axes):
    """``wrap_axes`` as a tuple of 3 bools, or ``None`` when no axis
    wraps."""
    if wrap_axes is None or not any(wrap_axes):
        return None
    return tuple(map(bool, wrap_axes))


# --------------------------------------------------------------------------
# constant folding (host Python floats, cast to f32 at the launch)
# --------------------------------------------------------------------------


def _density_folds(params, kernel):
    """``(inv2h, invh2, mfold)``: WendlandC2's ``w = sigma t^4 (2q+1)``
    with ``t = 1 - r/(2h)``, sigma folded into the mass (generic kernels
    evaluate ``w`` in full and fold only the mass)."""
    sigma = kernel._sigma(params.h, params.dim)
    mfold = params.mass * (sigma if kernel is WendlandC2 else 1.0)
    return 0.5 / params.h, 2.0 / params.h, mfold


def _accel_folds(params, kernel):
    """``(cfold, cv)`` as in ``tpgsd.sph.pallas_ops._accel_folds``:
    ``-mass * (press + pi) * dw_over_r`` becomes ``(pt_i + pt_j + cv
    min(vdotx, 0) / ((r2 + h2eps)(rho_i + rho_j))) * g`` with ``pt =
    cfold p / rho^2`` and ``g = t^3`` for WendlandC2 (``-dw_over_r``
    otherwise)."""
    if kernel is WendlandC2:
        cfold = 5.0 * params.mass * kernel._sigma(params.h, params.dim) / (
            params.h * params.h
        )
    else:
        cfold = params.mass
    cv = -2.0 * params.alpha * params.c0 * params.h * cfold
    return cfold, cv


def _drho_folds(params, kernel, delta_sph):
    """``(adrho, ddfold, eta2, rho_floor)`` of the continuity sum, as in
    ``tpgsd.sph.pallas_ops._accel_drho_kernel_packed``: with ``mass *
    dw_over_r = -cfold g``, both continuity terms share ``adrho =
    -cfold``, which scales the reduced sum once; the pair bracket is
    ``g (vdotx + ddfold (rho_i - rho_n) / rho_n r^2 / (r^2 + eta2))``
    with ``rho_n = max(rho_j, rho_floor)``."""
    cfold, _ = _accel_folds(params, kernel)
    ddfold = 2.0 * delta_sph * params.h * params.c0
    return -cfold, ddfold, (0.1 * params.h) ** 2, 0.1 * params.rho0


def _xsph_folds(params, kernel):
    """``xfold = 2 m sigma``: the XSPH sum is ``dv_i = xfold sum_j W'_ij
    (v_j - v_i) / (rho_i + rho_j)`` with ``W' = W / sigma`` (``t^4 (2q +
    1)`` for WendlandC2, the cubic spline at sigma 1)."""
    return 2.0 * params.mass * kernel._sigma(params.h, params.dim)


def _st_normals_folds(params, kernel):
    """``nfold = -hs cfold``: with ``m dW/dr / r = -cfold g`` (``g`` and
    ``cfold`` of :func:`_accel_folds`), the normal is ``n_i = nfold
    sum_j g(r) / rho_j (x_i - x_j)``."""
    cfold, _ = _accel_folds(params, kernel)
    return -kernel.support_scale * params.h * cfold


def _st_force_folds(params, kernel, gamma):
    """``(inv_hs, cohfold, kfold)`` of the surface-tension force.  With
    ``u = r / hs``, ``m C(r) = cohfold F(u)``, ``cohfold = 32 m / (pi
    hs^3)`` and ``F`` the spline in units of ``hs^6`` (``((1 - u) u)^3``
    past ``u = 1/2``, ``2 ((1 - u) u)^3 - 1/64`` below), so that the
    ``32 / (pi hs^9)`` of ``_cohesion_c`` (about 3e15 at the 1M dam
    break's hs) never meets an ``hs^6`` in float32; ``K_ij =
    2 rho0 / (rho_i + rho_j)`` and ``-gamma`` fold into ``kfold = -2
    gamma rho0``."""
    hs = kernel.support_scale * params.h
    return (1.0 / hs, 32.0 * params.mass / (math.pi * hs**3),
            -2.0 * gamma * params.rho0)


def pressure_plane(rho, p, params, kernel=WendlandC2):
    """The pre-scaled pressure plane ``cfold * p / (rho^2 + 1e-30)`` the
    acceleration kernel reads (``pallas_ops._pack_accel_fields``)."""
    cfold, _ = _accel_folds(params, kernel)
    return cfold * p / (rho * rho + 1e-30)


# --------------------------------------------------------------------------
# launches
# --------------------------------------------------------------------------


def _check_launch(grid, planes, fields, masks):
    """Validate the operands of one launch: CUDA, one device, float32
    planes ``[3, C, K]`` and fields ``[C, K]``, bool masks ``[C, K]``,
    all contiguous, ``1 <= K <= MAX_WIDE_CAPACITY``."""
    c, k = grid.n_cells, grid.capacity
    if not supported(grid):
        raise ValueError(
            "the CUDA pair kernels take 1 <= capacity <= %d; got %d"
            % (MAX_WIDE_CAPACITY, k)
        )
    dev = planes[0].device
    for t, shape, dtype in (
        [(t, (3, c, k), torch.float32) for t in planes]
        + [(t, (c, k), torch.float32) for t in fields]
        + [(t, (c, k), torch.bool) for t in masks]
    ):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                "pair kernels need every operand on one CUDA device; got "
                "%s and %s" % (dev, t.device)
            )
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                "pair kernel operand must be %s %s; got %s %s"
                % (dtype, shape, t.dtype, tuple(t.shape))
            )
        if not t.is_contiguous():
            raise ValueError("pair kernel operands must be contiguous")


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            "%s launch failed: CUDA error %d (%s)"
            % (name, rc, lib.tpgsd_error_string(rc).decode())
        )


def _role_key(family, grid, role):
    """The :data:`launch_counts` key of one launch: past
    :data:`MAX_CAPACITY` slots every pass is the single tier's, counted
    as ``<family>_wide``."""
    return "%s_%s" % (family, "wide" if grid.capacity > MAX_CAPACITY else role)


def _tile(grid, params, tile):
    """T of a tile launch: :func:`tile_cells` unless ``tile`` forces it
    (1 .. :data:`MAX_TILE`), for every family at any capacity."""
    tile = tile_cells(grid, params) if tile is None else int(tile)
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(
            "tile must be 1 .. %d cells; got %d" % (MAX_TILE, tile)
        )
    return tile


def tile_shared_bytes(family, grid, params, tile=None):
    """Bytes of dynamic shared memory one tile launch of ``family``
    (``"density"``, ``"accel"`` or ``"accel_drho"``) asks for on ``grid``
    at tile ``tile`` (:func:`tile_cells` by default), as the kernel
    library computes it for the launch: the staging buffer of (T + 2)
    min(K, 64) particles, the same at any capacity past 64."""
    t = _tile(grid, params, tile)
    return int(_build.load().tpgsd_tile_smem(
        int(family not in ("density", "st_normals")), t, grid.capacity))


def _launch_density(xc, mc, xn, mn, grid, params, kernel, role, tile=None):
    """One launch of the density tile kernel -> ``[C, K]``, counted as
    ``density_<role>`` and past :data:`MAX_CAPACITY` slots as
    ``density_wide``; ``tile`` cells per CTA (:func:`tile_cells` by
    default) at any capacity."""
    lib = _build.load()
    _check_launch(grid, (xc, xn), (), (mc, mn))
    code = kernel_code(kernel)
    inv2h, invh2, mfold = _density_folds(params, kernel)
    h = params.h
    supp2 = (kernel.support_scale * h) ** 2
    out = torch.empty_like(mc, dtype=torch.float32)
    nx, ny, nz = grid.dims
    tile = _tile(grid, params, tile)
    args = (xc.data_ptr(), mc.data_ptr(), xn.data_ptr(), mn.data_ptr(),
            out.data_ptr(), nx, ny, nz, grid.capacity)
    folds = (code, inv2h, invh2, mfold, h, kernel._sigma(h, params.dim), supp2)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_density_pairs(*args, tile, *folds, stream)
    key = _role_key("density", grid, role)
    _raise_on(lib, rc, key)
    launch_counts[key] += 1
    return out


#: the momentum kernel's instances by ``(drho, extra)``: launch-count
#: family and output planes (``extra`` ``"xsph"`` appends the three XSPH
#: sums; ``"energy"`` writes du/dt alone)
_MOMENTUM = {
    (False, None): ("accel", 3),
    (True, None): ("accel_drho", 4),
    (False, "xsph"): ("accel_xsph", 6),
    (True, "xsph"): ("accel_drho_xsph", 7),
    (False, "energy"): ("energy", 1),
}


def _launch_accel(xc, vc, rhoc, ptc, mc, xn, vn, rhon, ptn, mn, grid,
                  params, kernel, role, delta_sph=None, tile=None, extra=None):
    """One launch of the momentum tile kernel -> ``[3, C, K]``, or with
    ``delta_sph`` (a number, 0 included) of its fused momentum +
    continuity instance -> ``[4, C, K]``; ``extra="xsph"`` appends the
    XSPH correction's three planes (``[6 or 7, C, K]``) and
    ``extra="energy"`` launches the energy instance -> ``[C, K]``.
    Counted as ``<family>_<role>`` (:data:`_MOMENTUM`), and past
    :data:`MAX_CAPACITY` slots as ``<family>_wide``; ``tile`` cells per
    CTA (:func:`tile_cells` by default) at any capacity."""
    lib = _build.load()
    _check_launch(grid, (xc, vc, xn, vn), (rhoc, ptc, rhon, ptn), (mc, mn))
    code = kernel_code(kernel)
    _, cv = _accel_folds(params, kernel)
    drho = delta_sph is not None
    name, n_out = _MOMENTUM[(drho, extra)]
    drho_folds = _drho_folds(params, kernel, delta_sph) if drho else (0.0,) * 4
    xfold = _xsph_folds(params, kernel) if extra == "xsph" else 0.0
    h = params.h
    h2eps = params.eps * h * h
    supp2 = (kernel.support_scale * h) ** 2
    shape = tuple(mc.shape) if n_out == 1 else (n_out,) + tuple(mc.shape)
    out = xc.new_empty(shape)
    nx, ny, nz = grid.dims
    tile = _tile(grid, params, tile)
    args = (xc.data_ptr(), vc.data_ptr(), rhoc.data_ptr(), ptc.data_ptr(),
            mc.data_ptr(), xn.data_ptr(), vn.data_ptr(), rhon.data_ptr(),
            ptn.data_ptr(), mn.data_ptr(), out.data_ptr(), n_out,
            nx, ny, nz, grid.capacity)
    folds = (code, 0.5 / h, h, kernel._sigma(h, params.dim), h2eps, cv,
             supp2, *drho_folds, xfold)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_accel_pairs(*args, tile, *folds, stream)
    key = _role_key(name, grid, role)
    _raise_on(lib, rc, key)
    launch_counts[key] += 1
    return out


def _launch_st_normals(xc, mc, xn, rhon, mn, grid, params, kernel, role,
                       tile=None):
    """One launch of the surface-normal tile kernel -> ``[3, C, K]``,
    counted as ``st_normals_<role>`` (``st_normals_wide`` past
    :data:`MAX_CAPACITY` slots)."""
    lib = _build.load()
    _check_launch(grid, (xc, xn), (rhon,), (mc, mn))
    h = params.h
    out = xc.new_empty((3,) + tuple(mc.shape))
    nx, ny, nz = grid.dims
    args = (xc.data_ptr(), mc.data_ptr(), xn.data_ptr(), rhon.data_ptr(),
            mn.data_ptr(), out.data_ptr(), nx, ny, nz, grid.capacity)
    folds = (kernel_code(kernel), 0.5 / h, h, kernel._sigma(h, params.dim),
             (kernel.support_scale * h) ** 2, _st_normals_folds(params, kernel))
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_st_normals(*args, _tile(grid, params, tile), *folds,
                                  stream)
    key = _role_key("st_normals", grid, role)
    _raise_on(lib, rc, key)
    launch_counts[key] += 1
    return out


def _launch_st_force(xc, nc, rhoc, mc, xn, nn, rhon, mn, grid, params,
                     kernel, gamma, role, tile=None):
    """One launch of the surface-tension force tile kernel -> ``[3, C,
    K]``, counted as ``st_force_<role>`` (``st_force_wide`` past
    :data:`MAX_CAPACITY` slots)."""
    lib = _build.load()
    _check_launch(grid, (xc, nc, xn, nn), (rhoc, rhon), (mc, mn))
    out = xc.new_empty((3,) + tuple(mc.shape))
    nx, ny, nz = grid.dims
    args = (xc.data_ptr(), nc.data_ptr(), rhoc.data_ptr(), mc.data_ptr(),
            xn.data_ptr(), nn.data_ptr(), rhon.data_ptr(), mn.data_ptr(),
            out.data_ptr(), nx, ny, nz, grid.capacity)
    folds = ((kernel.support_scale * params.h) ** 2,
             *_st_force_folds(params, kernel, gamma))
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_st_force(*args, _tile(grid, params, tile), *folds,
                                stream)
    key = _role_key("st_force", grid, role)
    _raise_on(lib, rc, key)
    launch_counts[key] += 1
    return out


# --------------------------------------------------------------------------
# per-pass wrappers and their plain versions
# --------------------------------------------------------------------------


def _table(grid, device, wrap_axes):
    """The neighbour table and minimum image of the plain versions for
    ``wrap_axes``."""
    periodic = _wrapped(wrap_axes) or False
    return (neighbor_index(grid, device, periodic),
            minimum_image(grid, device, periodic))


def density_pairs_plain(xc, mc, xn, mn, grid, params, kernel=WendlandC2,
                        wrap_axes=None):
    """Plain version of :func:`density_pairs`; ``wrap_axes`` wraps these
    axes through the neighbour table and the minimum image."""
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    return _density_blocks(xc, mc, xn, mn, nbr, params, kernel, mimage)


def density_pairs(xc, mc, xn, mn, grid, params, kernel=WendlandC2,
                  cross=False, tile=None):
    """Density contribution ``[C, K]`` to the centres of one tier
    (``xc [3, C, K]``, live mask ``mc [C, K]``) from the neighbours of a
    tier (``xn``, ``mn``): ``m_i * mass * sum_j m_j W(r_ij)`` over the
    27 neighbour cells.  ``cross`` names the role (centres and
    neighbours from different tiers) for the launch count; ``tile``
    forces the kernel's cells per CTA (:func:`tile_cells` by default)."""
    if _on_cpu(xc, mc, xn, mn):
        return density_pairs_plain(xc, mc, xn, mn, grid, params, kernel)
    return _launch_density(
        xc, mc, xn, mn, grid, params, kernel, "cross" if cross else "self",
        tile,
    )


def xsph_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                     kernel=WendlandC2, wrap_axes=None):
    """Plain XSPH correction ``[3, C, K]`` of the centres of one tier from
    the neighbours of a tier (operands as :func:`accel_pairs`; the
    pressure is not read): the three planes that ``xsph=True`` appends to
    the momentum passes."""
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    return _xsph_blocks(xc, vc, rhoc, mc, xn, vn, rhon, mn, nbr, params,
                        kernel, mimage)


def accel_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid,
                      params, kernel=WendlandC2, wrap_axes=None, xsph=False):
    """Plain version of :func:`accel_pairs`; ``wrap_axes`` as in
    :func:`density_pairs_plain`."""
    tiers = (xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn)
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    out = _accel_blocks(*tiers, nbr, params, kernel, mimage)
    if xsph:
        out = torch.cat([out, xsph_pairs_plain(*tiers, grid, params, kernel,
                                               wrap_axes)])
    return out


def accel_pairs(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                kernel=WendlandC2, cross=False, tile=None, xsph=False):
    """Pressure + viscosity acceleration ``[3, C, K]`` of the centres of
    one tier from the neighbours of a tier (positions and velocities
    ``[3, C, K]``, density, pressure and live mask ``[C, K]``).  Dead
    slots must carry a positive density (the step sets ``rho0``).
    ``xsph`` appends the XSPH correction's three planes (``[6, C, K]``,
    launched as ``accel_xsph``).  ``cross`` and ``tile`` as in
    :func:`density_pairs`."""
    if _on_cpu(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn):
        return accel_pairs_plain(
            xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params, kernel,
            xsph=xsph,
        )
    return _launch_accel(
        xc, vc, rhoc, pressure_plane(rhoc, pc, params, kernel), mc,
        xn, vn, rhon, pressure_plane(rhon, pn, params, kernel), mn,
        grid, params, kernel, "cross" if cross else "self", tile=tile,
        extra="xsph" if xsph else None,
    )


def accel_drho_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid,
                           params, kernel=WendlandC2, delta_sph=0.1,
                           wrap_axes=None, xsph=False):
    """Plain version of :func:`accel_drho_pairs`; ``wrap_axes`` as in
    :func:`density_pairs_plain`."""
    tiers = (xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn)
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    out = _accel_drho_blocks(*tiers, nbr, params, kernel, delta_sph, mimage)
    if xsph:
        out = torch.cat([out, xsph_pairs_plain(*tiers, grid, params, kernel,
                                               wrap_axes)])
    return out


def accel_drho_pairs(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                     kernel=WendlandC2, delta_sph=0.1, cross=False,
                     tile=None, xsph=False):
    """Fused momentum + continuity pass ``[4, C, K]`` (acc_x, acc_y,
    acc_z, drho/dt) of the centres of one tier from the neighbours of a
    tier; operands as :func:`accel_pairs`.  ``delta_sph`` is the
    delta-SPH density-diffusion strength (0 = off).  Live densities must
    be floored at ``0.1 rho0`` and dead slots carry ``rho0`` (the step
    does both): the kernel floors the neighbour density of the diffusion
    term there, the plain version does not.  ``xsph`` appends the XSPH
    correction (``[7, C, K]``, launched as ``accel_drho_xsph``).
    ``cross`` and ``tile`` as in :func:`density_pairs`."""
    if _on_cpu(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn):
        return accel_drho_pairs_plain(
            xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params, kernel,
            delta_sph, xsph=xsph,
        )
    return _launch_accel(
        xc, vc, rhoc, pressure_plane(rhoc, pc, params, kernel), mc,
        xn, vn, rhon, pressure_plane(rhon, pn, params, kernel), mn,
        grid, params, kernel, "cross" if cross else "self", delta_sph, tile,
        "xsph" if xsph else None,
    )


def energy_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid,
                       params, kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`energy_pairs`; ``wrap_axes`` as in
    :func:`density_pairs_plain`."""
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    return _energy_blocks(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr,
                          params, kernel, mimage)


def energy_pairs(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                 kernel=WendlandC2, cross=False, tile=None):
    """Internal-energy rate ``[C, K]`` (du/dt) of the centres of one tier
    from the neighbours of a tier, the conjugate of :func:`accel_pairs`
    on the same operands: the energy instance of the momentum kernel
    sums ``-1/2 scale_ij (v_ij . x_ij)`` with the very ``scale_ij`` that
    the acceleration sums.  ``cross`` and ``tile`` as in
    :func:`density_pairs`."""
    if _on_cpu(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn):
        return energy_pairs_plain(
            xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params, kernel
        )
    return _launch_accel(
        xc, vc, rhoc, pressure_plane(rhoc, pc, params, kernel), mc,
        xn, vn, rhon, pressure_plane(rhon, pn, params, kernel), mn,
        grid, params, kernel, "cross" if cross else "self", tile=tile,
        extra="energy",
    )


def st_normals_pairs_plain(xc, mc, xn, rhon, mn, grid, params,
                           kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_normals_pairs`; ``wrap_axes`` as in
    :func:`density_pairs_plain`."""
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    return _st_normals_blocks(xc, mc, xn, rhon, mn, nbr, params, kernel,
                              mimage)


def st_normals_pairs(xc, mc, xn, rhon, mn, grid, params, kernel=WendlandC2,
                     cross=False, tile=None):
    """Akinci surface normals ``[3, C, K]`` of the centres of one tier
    (``xc [3, C, K]``, live mask ``mc``) from the neighbours of a tier
    (positions, density and live mask; dead slots carry a positive
    density).  ``cross`` and ``tile`` as in :func:`density_pairs`."""
    if _on_cpu(xc, mc, xn, rhon, mn):
        return st_normals_pairs_plain(xc, mc, xn, rhon, mn, grid, params,
                                      kernel)
    return _launch_st_normals(xc, mc, xn, rhon, mn, grid, params, kernel,
                              "cross" if cross else "self", tile)


def st_force_pairs_plain(xc, nc, rhoc, mc, xn, nn, rhon, mn, grid, params,
                         gamma, kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_force_pairs`; ``wrap_axes`` as in
    :func:`density_pairs_plain`."""
    nbr, mimage = _table(grid, xc.device, wrap_axes)
    return _st_force_blocks(xc, nc, rhoc, mc, xn, nn, rhon, mn, nbr, params,
                            kernel, gamma, mimage)


def st_force_pairs(xc, nc, rhoc, mc, xn, nn, rhon, mn, grid, params, gamma,
                   kernel=WendlandC2, cross=False, tile=None):
    """Akinci surface-tension acceleration ``[3, C, K]`` (cohesion and
    curvature, strength ``gamma``) of the centres of one tier from the
    neighbours of a tier: positions and normals ``[3, C, K]``, density
    and live mask ``[C, K]`` (dead slots carry a positive density).  The
    normals must be complete (every tier's contribution summed) before
    this pass.  As in the reference, the curvature term ``n_i - n_j``
    sums over every live neighbour of the 27 cells, within the support
    or not.  ``cross`` and ``tile`` as in :func:`density_pairs`."""
    if _on_cpu(xc, nc, rhoc, mc, xn, nn, rhon, mn):
        return st_force_pairs_plain(xc, nc, rhoc, mc, xn, nn, rhon, mn, grid,
                                    params, gamma, kernel)
    return _launch_st_force(xc, nc, rhoc, mc, xn, nn, rhon, mn, grid, params,
                            kernel, gamma, "cross" if cross else "self", tile)


# --------------------------------------------------------------------------
# periodic boundaries: pre-shifted ghost-cell halos
# (pallas_ops._ghost_maps / _ghost_tier)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _ghost_maps(grid, wrap_axes):
    """Host ghost-halo maps for ``wrap_axes`` (a tuple of 3 bools).

    Returns ``(ghost_grid, src, shift, interior)``: ``src[Cg]`` is each
    ghost-grid cell's source cell id in the original grid, ``shift[Cg,
    3]`` the periodic-image position offset, ``interior[C]`` the
    ghost-linear ids of the original cells in original order.
    """
    _, ny, nz = grid.dims
    g = grid._replace(
        dims=tuple(d + 2 * int(w) for d, w in zip(grid.dims, wrap_axes)),
        lo=tuple(
            l - grid.cell_size * int(w) for l, w in zip(grid.lo, wrap_axes)
        ),
    )
    coords, images = [], []
    for n, w in zip(grid.dims, wrap_axes):
        c = np.arange(n + 2 * int(w)) - int(w)
        images.append(np.where(c < 0, -1, np.where(c >= n, 1, 0)))
        coords.append(np.mod(c, n))
    sx, sy, sz = np.meshgrid(*coords, indexing="ij")
    mx, my, mz = np.meshgrid(*images, indexing="ij")
    src = ((sx * ny + sy) * nz + sz).astype(np.int32).ravel()
    ext = grid.cell_size * np.asarray(grid.dims, np.float64)
    shift = np.stack(
        [mx.ravel() * ext[0], my.ravel() * ext[1], mz.ravel() * ext[2]],
        axis=-1,
    ).astype(np.float32)
    interior = np.nonzero(
        ((mx == 0) & (my == 0) & (mz == 0)).ravel()
    )[0].astype(np.int32)
    return g, src, shift, interior


@functools.lru_cache(maxsize=8)
def _ghost_index(grid, wrap_axes, device):
    """:func:`_ghost_maps` with the index maps on ``device``: ``(ghost
    grid, src [Cg] int64, shift [3, Cg, 1], interior [C] int64)``,
    cached per grid, wrap tuple and device (callers must not write to
    them)."""
    g, src, shift, interior = _ghost_maps(grid, wrap_axes)
    return (
        g,
        torch.from_numpy(src.astype(np.int64)).to(device),
        torch.from_numpy(np.ascontiguousarray(shift.T)).to(device)[:, :, None],
        torch.from_numpy(interior.astype(np.int64)).to(device),
    )


def _ghost_tier(tier, src, shift):
    """Ghost-halo expansion of one tier ``(x [3, C, K], *fields)``: every
    plane gathered over ``src`` along its cell axis, the positions
    pre-shifted by the image offset."""
    out = [t.index_select(-2, src) for t in tier]
    out[0] = out[0] + shift
    return tuple(out)


# --------------------------------------------------------------------------
# the single-tier entry points (pallas_ops.density / accel / accel_drho)
# --------------------------------------------------------------------------


def _single_tier(pairs, tier, grid, wrap_axes):
    """One single-tier pass ``pairs(tier, grid)`` -> ``[..., C, K]``, on
    the ghost grid and selected back to the interior rows when
    ``wrap_axes`` wraps an axis."""
    wrap = _wrapped(wrap_axes)
    if wrap is None:
        return pairs(tier, grid)
    g, src, shift, interior = _ghost_index(grid, wrap, tier[0].device)
    return pairs(_ghost_tier(tier, src, shift), g).index_select(-2, interior)


def density(dense_x, mask, grid, params, kernel=WendlandC2, wrap_axes=None):
    """Per-slot SPH density ``[C, K]`` of one tier (SoA positions ``[3,
    C, K]``, live mask ``[C(+1), K]``): 0 in dead slots.  ``wrap_axes``
    (3 bools) wraps these axes through a ghost-cell halo.  CPU tensors
    take the plain pass; CUDA tensors launch the density tile kernel in
    its self role, counted as ``density_wide`` past 64 slots per cell."""
    def pairs(tier, g):
        x, m = tier
        if _on_cpu(x, m):
            return density_pairs_plain(x, m, x, m, g, params, kernel)
        return _launch_density(x, m, x, m, g, params, kernel, "self")

    tier = (dense_x, mask[: grid.n_cells])
    return _single_tier(pairs, tier, grid, wrap_axes)


def density_plain(dense_x, mask, grid, params, kernel=WendlandC2,
                  wrap_axes=None):
    """Plain version of :func:`density` (any device; ``wrap_axes`` through
    the wrapped neighbour table and the minimum image)."""
    m = mask[: grid.n_cells]
    return density_pairs_plain(
        dense_x, m, dense_x, m, grid, params, kernel, wrap_axes
    )


def _momentum_plain(cen, nbr, grid, params, kernel, delta_sph, extra,
                    wrap_axes=None):
    """The plain version of one momentum-kernel launch on tiers ``cen``
    and ``nbr`` (each ``(x, v, rho, p, mask)``): ``delta_sph`` and
    ``extra`` as in :func:`_launch_accel`."""
    if extra == "energy":
        return energy_pairs_plain(*cen, *nbr, grid, params, kernel, wrap_axes)
    xsph = extra == "xsph"
    if delta_sph is None:
        return accel_pairs_plain(*cen, *nbr, grid, params, kernel, wrap_axes,
                                 xsph)
    return accel_drho_pairs_plain(*cen, *nbr, grid, params, kernel, delta_sph,
                                  wrap_axes, xsph)


def _accel_single_tier(tier, grid, params, kernel, delta_sph, wrap_axes,
                       extra=None):
    """The momentum pass of one tier ``(x, v, rho, p, mask)`` -> ``[3, C,
    K]``, or with ``delta_sph`` (a number, 0 included) the fused momentum
    + continuity pass -> ``[4, C, K]``; ``extra`` as in
    :func:`_launch_accel`."""
    c = grid.n_cells
    tier = tier[:2] + tuple(f[:c] for f in tier[2:])
    if _on_cpu(*tier):
        def pairs(t, g):
            return _momentum_plain(t, t, g, params, kernel, delta_sph, extra)
    else:
        tier = (
            tier[:3] + (pressure_plane(tier[2], tier[3], params, kernel),)
            + tier[4:]
        )

        def pairs(t, g):
            return _launch_accel(*t, *t, g, params, kernel, "self", delta_sph,
                                 extra=extra)

    return _single_tier(pairs, tier, grid, wrap_axes)


def _plain_tier(dense_x, dense_v, dense_rho, dense_p, mask, grid):
    c = grid.n_cells
    return (dense_x, dense_v, dense_rho[:c], dense_p[:c], mask[:c])


def accel(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
          kernel=WendlandC2, wrap_axes=None, xsph=False):
    """Per-slot pressure + viscosity acceleration ``[3, C, K]`` of one
    tier (positions and velocities ``[3, C, K]``; density, pressure and
    live mask ``[C(+1), K]``); operands as :func:`accel_pairs`,
    ``wrap_axes`` and dispatch as :func:`density`.  ``xsph`` appends the
    XSPH correction (``[6, C, K]``) from the same launch."""
    return _accel_single_tier(
        (dense_x, dense_v, dense_rho, dense_p, mask), grid, params, kernel,
        None, wrap_axes, "xsph" if xsph else None,
    )


def accel_plain(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
                kernel=WendlandC2, wrap_axes=None, xsph=False):
    """Plain version of :func:`accel` (as :func:`density_plain`)."""
    t = _plain_tier(dense_x, dense_v, dense_rho, dense_p, mask, grid)
    return accel_pairs_plain(*t, *t, grid, params, kernel, wrap_axes, xsph)


def accel_drho(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
               kernel=WendlandC2, delta_sph=0.1, wrap_axes=None, xsph=False):
    """Fused momentum + continuity pass ``[4, C, K]`` (acc_x, acc_y,
    acc_z, drho/dt) of one tier; operands as :func:`accel_drho_pairs`,
    ``wrap_axes`` and dispatch as :func:`density`.  ``xsph`` appends the
    XSPH correction (``[7, C, K]``) from the same launch."""
    return _accel_single_tier(
        (dense_x, dense_v, dense_rho, dense_p, mask), grid, params, kernel,
        delta_sph, wrap_axes, "xsph" if xsph else None,
    )


def accel_drho_plain(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
                     kernel=WendlandC2, delta_sph=0.1, wrap_axes=None,
                     xsph=False):
    """Plain version of :func:`accel_drho` (as :func:`density_plain`)."""
    t = _plain_tier(dense_x, dense_v, dense_rho, dense_p, mask, grid)
    return accel_drho_pairs_plain(
        *t, *t, grid, params, kernel, delta_sph, wrap_axes, xsph
    )


def energy(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
           kernel=WendlandC2, wrap_axes=None):
    """Per-slot internal-energy rate ``[C, K]`` of one tier, the
    conjugate of :func:`accel` on the same operands; ``wrap_axes`` and
    dispatch as :func:`density` (launch key ``energy_self``,
    ``energy_wide`` past 64 slots)."""
    return _accel_single_tier(
        (dense_x, dense_v, dense_rho, dense_p, mask), grid, params, kernel,
        None, wrap_axes, "energy",
    )


def energy_plain(dense_x, dense_v, dense_rho, dense_p, mask, grid, params,
                 kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`energy` (as :func:`density_plain`)."""
    t = _plain_tier(dense_x, dense_v, dense_rho, dense_p, mask, grid)
    return energy_pairs_plain(*t, *t, grid, params, kernel, wrap_axes)


def surface_tension(dense_x, dense_rho, mask, grid, params, gamma,
                    kernel=WendlandC2, wrap_axes=None):
    """Per-slot Akinci surface-tension acceleration ``[3, C, K]`` of one
    tier (positions ``[3, C, K]``; density and live mask ``[C(+1), K]``,
    dead slots at a positive density): the normals pass, then the force
    pass, each a self-role launch (``st_normals``, ``st_force``; ``_wide``
    past 64 slots).  With ``wrap_axes`` the normals are computed on the
    ghost grid, selected back to the interior rows (a halo cell's own
    neighbourhood is truncated) and only then ghost-expanded, unshifted,
    for the force pass.  CPU tensors take the plain passes."""
    n = st_normals(dense_x, dense_rho, mask, grid, params, kernel, wrap_axes)
    return st_force(dense_x, n, dense_rho, mask, grid, params, gamma, kernel,
                    wrap_axes)


def surface_tension_plain(dense_x, dense_rho, mask, grid, params, gamma,
                          kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`surface_tension` (as
    :func:`density_plain`)."""
    n = st_normals_plain(dense_x, dense_rho, mask, grid, params, kernel,
                         wrap_axes)
    return st_force_plain(dense_x, n, dense_rho, mask, grid, params, gamma,
                          kernel, wrap_axes)


def st_normals(dense_x, dense_rho, mask, grid, params, kernel=WendlandC2,
               wrap_axes=None):
    """The normals pass of :func:`surface_tension` alone -> ``[3, C,
    K]``: on the ghost grid, selected back to the interior rows, with
    ``wrap_axes``.  A decomposed step exchanges the owners' normals of
    its halo planes between this pass and :func:`st_force`."""
    c = grid.n_cells

    def normals(t, g):
        tx, tr, tm = t
        return st_normals_pairs(tx, tm, tx, tr, tm, g, params, kernel)

    return _single_tier(normals, (dense_x, dense_rho[:c], mask[:c]), grid,
                        wrap_axes)


def st_normals_plain(dense_x, dense_rho, mask, grid, params,
                     kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_normals` (as :func:`density_plain`)."""
    c = grid.n_cells
    x, rho, m = dense_x, dense_rho[:c], mask[:c]
    return st_normals_pairs_plain(x, m, x, rho, m, grid, params, kernel,
                                  wrap_axes)


def st_force(dense_x, normals, dense_rho, mask, grid, params, gamma,
             kernel=WendlandC2, wrap_axes=None):
    """The force pass of :func:`surface_tension` from complete
    ``normals [3, C, K]`` -> ``[3, C, K]``; with ``wrap_axes`` the
    normals are ghost-expanded unshifted."""
    c = grid.n_cells

    def force(t, g):
        return st_force_pairs(*t, *t, g, params, gamma, kernel)

    # the normals ride as element 1: _ghost_tier shifts only element 0
    return _single_tier(force, (dense_x, normals, dense_rho[:c], mask[:c]),
                        grid, wrap_axes)


def st_force_plain(dense_x, normals, dense_rho, mask, grid, params, gamma,
                   kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_force` (as :func:`density_plain`)."""
    c = grid.n_cells
    x, rho, m = dense_x, dense_rho[:c], mask[:c]
    return st_force_pairs_plain(x, normals, rho, m, x, normals, rho, m, grid,
                                params, gamma, kernel, wrap_axes)


# --------------------------------------------------------------------------
# the two-tier entry points (pallas_ops.density_spill / accel_spill /
# accel_drho_spill)
# --------------------------------------------------------------------------


def _two_tier(pairs, a, b, grid, wrap_axes=None):
    """``(AA + AB, BB + BA)``: the two-tier sums of one pair pass
    ``pairs(centres, neighbours, role, grid)`` over tiers ``a`` and ``b``
    (as ``pallas_ops.density_spill`` / ``accel_spill`` sum them), each
    ``[..., C, K]``; with ``wrap_axes`` on the ghost halo of both tiers,
    selected back to the interior rows."""
    wrap = _wrapped(wrap_axes)
    if wrap is not None:
        grid, src, shift, interior = _ghost_index(grid, wrap, a[0].device)
        a, b = _ghost_tier(a, src, shift), _ghost_tier(b, src, shift)
    out = (
        pairs(a, a, "self", grid) + pairs(a, b, "cross", grid),
        pairs(b, b, "self", grid) + pairs(b, a, "cross", grid),
    )
    if wrap is not None:
        out = tuple(o.index_select(-2, interior) for o in out)
    return out


def _density_tiers(x_a, mask_a, x_b, mask_b, grid):
    c = grid.n_cells
    return (x_a, mask_a[:c]), (x_b, mask_b[:c])


def density_spill(dense_x_a, mask_a, dense_x_b, mask_b, grid, params,
                  kernel=WendlandC2, wrap_axes=None):
    """Two-tier SPH density: main tier A (slots < K) + spill tier B, SoA
    positions ``[3, C, K]`` and masks ``[C(+1), K]``.  Returns ``(rho_a,
    rho_b)``, each ``[C, K]``: ``rho_a = AA + AB``, ``rho_b = BB + BA``.
    ``wrap_axes`` wraps these axes through a ghost-cell halo of both
    tiers.  CPU tensors take the plain pair passes; CUDA tensors launch
    the density kernel four times."""
    a, b = _density_tiers(dense_x_a, mask_a, dense_x_b, mask_b, grid)
    if _on_cpu(*a, *b):
        def pairs(cen, nbr, role, g):
            return density_pairs_plain(*cen, *nbr, g, params, kernel)
    else:
        def pairs(cen, nbr, role, g):
            return _launch_density(*cen, *nbr, g, params, kernel, role)

    return _two_tier(pairs, a, b, grid, wrap_axes)


def density_spill_plain(dense_x_a, mask_a, dense_x_b, mask_b, grid, params,
                        kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`density_spill` (any device; ``wrap_axes``
    through the wrapped neighbour table and the minimum image)."""
    a, b = _density_tiers(dense_x_a, mask_a, dense_x_b, mask_b, grid)
    return _two_tier(
        lambda cen, nbr, role, g: density_pairs_plain(
            *cen, *nbr, g, params, kernel, wrap_axes
        ),
        a, b, grid,
    )


def _accel_two_tier(a, b, grid, params, kernel, delta_sph, plain, wrap_axes,
                    extra=None):
    """Two-tier sums ``(AA + AB, BB + BA)`` of the momentum pass, or with
    ``delta_sph`` (a number, 0 included) of the fused momentum +
    continuity pass, over tiers ``a`` and ``b`` (each ``(x, v, rho, p,
    mask)``), as ``[C, K, F]`` views of the SoA sums (``extra`` ``None``
    or ``"xsph"``, as in :func:`_launch_accel`).  ``plain``
    takes the plain pair passes with ``wrap_axes`` in the neighbour table
    and the minimum image; otherwise ``wrap_axes`` is the ghost halo, on
    which CPU tensors take the plain pair passes and CUDA tensors launch
    the kernel four times, with each tier's pressure plane folded once
    for its two passes."""
    c = grid.n_cells
    a, b = (t[:2] + tuple(f[:c] for f in t[2:]) for t in (a, b))
    if plain or _on_cpu(*a, *b):
        table_wrap = wrap_axes if plain else None

        def pairs(cen, nbr, role, g):
            return _momentum_plain(cen, nbr, g, params, kernel, delta_sph,
                                   extra, table_wrap)
    else:
        a, b = (
            t[:3] + (pressure_plane(t[2], t[3], params, kernel),) + t[4:]
            for t in (a, b)
        )

        def pairs(cen, nbr, role, g):
            return _launch_accel(
                *cen, *nbr, g, params, kernel, role, delta_sph, extra=extra
            )

    out_a, out_b = _two_tier(
        pairs, a, b, grid, None if plain else wrap_axes
    )
    return out_a.permute(1, 2, 0), out_b.permute(1, 2, 0)


def accel_spill(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, wrap_axes=None, xsph=False,
):
    """Two-tier SPH acceleration, the counterpart of
    :func:`density_spill`.  Returns ``(acc_a, acc_b)``, each ``[C, K,
    3]`` (views of the SoA sums): ``acc_a = AA + AB``, ``acc_b = BB +
    BA``; ``xsph`` appends the XSPH correction as columns 3-5.  CPU
    tensors take the plain pair passes; CUDA tensors launch the
    acceleration kernel four times."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, None, False, wrap_axes,
        "xsph" if xsph else None,
    )


def accel_spill_plain(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, wrap_axes=None, xsph=False,
):
    """Plain version of :func:`accel_spill` (as
    :func:`density_spill_plain`)."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, None, True, wrap_axes,
        "xsph" if xsph else None,
    )


def accel_drho_spill(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, delta_sph=0.1, wrap_axes=None,
    xsph=False,
):
    """Two-tier fused momentum + continuity pass (continuity-density mode
    on the spill layout), the drho counterpart of :func:`accel_spill`.
    Returns ``(out4_a, out4_b)``, each ``[C, K, 4]`` (views of the SoA
    sums) with columns acc_x, acc_y, acc_z, drho/dt: ``out4_a = AA + AB``,
    ``out4_b = BB + BA``; ``xsph`` appends the XSPH correction as
    columns 4-6.  CPU tensors take the plain pair passes; CUDA tensors
    launch the fused kernel four times."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, delta_sph, False, wrap_axes,
        "xsph" if xsph else None,
    )


def accel_drho_spill_plain(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, delta_sph=0.1, wrap_axes=None,
    xsph=False,
):
    """Plain version of :func:`accel_drho_spill` (as
    :func:`density_spill_plain`)."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, delta_sph, True, wrap_axes,
        "xsph" if xsph else None,
    )


def _st_normals_two_tier(x_a, rho_a, mask_a, x_b, rho_b, mask_b, grid,
                         params, kernel, plain, wrap_axes):
    """Two-tier surface normals ``(AA + AB, BB + BA)``, each ``[3, C,
    K]``, complete (their own and the other tier's neighbours).
    ``plain`` and ``wrap_axes`` as in :func:`_accel_two_tier`; on the
    ghost halo the normals are selected back to the interior rows."""
    c = grid.n_cells
    table_wrap = wrap_axes if plain else None

    def normals(cen, nbr, role, g):
        args = (cen[0], cen[2], nbr[0], nbr[1], nbr[2], g, params, kernel)
        if plain:
            return st_normals_pairs_plain(*args, table_wrap)
        return st_normals_pairs(*args, cross=role == "cross")

    return _two_tier(normals, (x_a, rho_a[:c], mask_a[:c]),
                     (x_b, rho_b[:c], mask_b[:c]), grid,
                     None if plain else wrap_axes)


def _st_force_two_tier(x_a, n_a, rho_a, mask_a, x_b, n_b, rho_b, mask_b,
                       grid, params, gamma, kernel, plain, wrap_axes):
    """Two-tier surface-tension force ``(AA + AB, BB + BA)`` as ``[C, K,
    3]`` views from complete normals ``n_a``, ``n_b`` (``[3, C, K]``);
    on the ghost halo the normals are expanded again, unshifted (element
    1 of its tiers)."""
    c = grid.n_cells
    table_wrap = wrap_axes if plain else None

    def force(cen, nbr, role, g):
        if plain:
            return st_force_pairs_plain(*cen, *nbr, g, params, gamma, kernel,
                                        table_wrap)
        return st_force_pairs(*cen, *nbr, g, params, gamma, kernel,
                              cross=role == "cross")

    f_a, f_b = _two_tier(
        force, (x_a, n_a, rho_a[:c], mask_a[:c]),
        (x_b, n_b, rho_b[:c], mask_b[:c]), grid,
        None if plain else wrap_axes,
    )
    return f_a.permute(1, 2, 0), f_b.permute(1, 2, 0)


def _surface_tension_two_tier(x_a, rho_a, mask_a, x_b, rho_b, mask_b, grid,
                              params, gamma, kernel, plain, wrap_axes):
    """Two-tier surface tension ``(AA + AB, BB + BA)`` as ``[C, K, 3]``
    views: both tiers' normals are complete before any force pass."""
    n_a, n_b = _st_normals_two_tier(x_a, rho_a, mask_a, x_b, rho_b, mask_b,
                                    grid, params, kernel, plain, wrap_axes)
    return _st_force_two_tier(x_a, n_a, rho_a, mask_a, x_b, n_b, rho_b,
                              mask_b, grid, params, gamma, kernel, plain,
                              wrap_axes)


def surface_tension_spill(dense_x_a, dense_rho_a, mask_a, dense_x_b,
                          dense_rho_b, mask_b, grid, params, gamma,
                          kernel=WendlandC2, wrap_axes=None):
    """Two-tier Akinci surface-tension acceleration of strength
    ``gamma``: ``(st_a, st_b)``, each ``[C, K, 3]``, from SoA positions
    ``[3, C, K]``, densities and masks ``[C(+1), K]``.  CPU tensors take
    the plain pair passes; CUDA tensors launch the normals kernel four
    times, then the force kernel four times."""
    return _surface_tension_two_tier(
        dense_x_a, dense_rho_a, mask_a, dense_x_b, dense_rho_b, mask_b, grid,
        params, gamma, kernel, False, wrap_axes,
    )


def surface_tension_spill_plain(dense_x_a, dense_rho_a, mask_a, dense_x_b,
                                dense_rho_b, mask_b, grid, params, gamma,
                                kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`surface_tension_spill` (as
    :func:`density_spill_plain`)."""
    return _surface_tension_two_tier(
        dense_x_a, dense_rho_a, mask_a, dense_x_b, dense_rho_b, mask_b, grid,
        params, gamma, kernel, True, wrap_axes,
    )


def st_normals_spill(dense_x_a, dense_rho_a, mask_a, dense_x_b, dense_rho_b,
                     mask_b, grid, params, kernel=WendlandC2, wrap_axes=None):
    """The normals passes of :func:`surface_tension_spill` alone: ``(n_a,
    n_b)``, each ``[3, C, K]`` (four launches on CUDA).  A decomposed
    step exchanges the owners' normals of its halo planes between these
    and :func:`st_force_spill`."""
    return _st_normals_two_tier(dense_x_a, dense_rho_a, mask_a, dense_x_b,
                                dense_rho_b, mask_b, grid, params, kernel,
                                False, wrap_axes)


def st_normals_spill_plain(dense_x_a, dense_rho_a, mask_a, dense_x_b,
                           dense_rho_b, mask_b, grid, params,
                           kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_normals_spill` (as
    :func:`density_spill_plain`)."""
    return _st_normals_two_tier(dense_x_a, dense_rho_a, mask_a, dense_x_b,
                                dense_rho_b, mask_b, grid, params, kernel,
                                True, wrap_axes)


def st_force_spill(dense_x_a, normals_a, dense_rho_a, mask_a, dense_x_b,
                   normals_b, dense_rho_b, mask_b, grid, params, gamma,
                   kernel=WendlandC2, wrap_axes=None):
    """The force passes of :func:`surface_tension_spill` from complete
    normals (``[3, C, K]`` each): ``(st_a, st_b)``, each ``[C, K, 3]``
    (four launches on CUDA)."""
    return _st_force_two_tier(dense_x_a, normals_a, dense_rho_a, mask_a,
                              dense_x_b, normals_b, dense_rho_b, mask_b, grid,
                              params, gamma, kernel, False, wrap_axes)


def st_force_spill_plain(dense_x_a, normals_a, dense_rho_a, mask_a,
                         dense_x_b, normals_b, dense_rho_b, mask_b, grid,
                         params, gamma, kernel=WendlandC2, wrap_axes=None):
    """Plain version of :func:`st_force_spill` (as
    :func:`density_spill_plain`)."""
    return _st_force_two_tier(dense_x_a, normals_a, dense_rho_a, mask_a,
                              dense_x_b, normals_b, dense_rho_b, mask_b, grid,
                              params, gamma, kernel, True, wrap_axes)


def _energy_two_tier(a, b, grid, params, kernel, plain, wrap_axes):
    """Two-tier internal-energy rates ``(AA + AB, BB + BA)``, each ``[C,
    K]``, over tiers ``(x, v, rho, p, mask)``; ``plain`` and
    ``wrap_axes`` as in :func:`_accel_two_tier`."""
    c = grid.n_cells
    a, b = (t[:2] + tuple(f[:c] for f in t[2:]) for t in (a, b))
    if plain or _on_cpu(*a, *b):
        table_wrap = wrap_axes if plain else None

        def pairs(cen, nbr, role, g):
            return energy_pairs_plain(*cen, *nbr, g, params, kernel,
                                      table_wrap)
    else:
        a, b = (
            t[:3] + (pressure_plane(t[2], t[3], params, kernel),) + t[4:]
            for t in (a, b)
        )

        def pairs(cen, nbr, role, g):
            return _launch_accel(*cen, *nbr, g, params, kernel, role,
                                 extra="energy")

    return _two_tier(pairs, a, b, grid, None if plain else wrap_axes)


def energy_spill(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, wrap_axes=None,
):
    """Two-tier internal-energy rate, the conjugate of
    :func:`accel_spill` on the same operands: ``(du_a, du_b)``, each
    ``[C, K]``.  CPU tensors take the plain pair passes; CUDA tensors
    launch the energy instance of the momentum kernel four times
    (``energy_self``, ``energy_cross``)."""
    return _energy_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, False, wrap_axes,
    )


def energy_spill_plain(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, wrap_axes=None,
):
    """Plain version of :func:`energy_spill` (as
    :func:`density_spill_plain`)."""
    return _energy_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, True, wrap_axes,
    )


# --------------------------------------------------------------------------
# the one choice of pair passes (global, slab-sequential and decomposed
# steps)
# --------------------------------------------------------------------------


class PairOps(NamedTuple):
    """The pair passes of one layout and density mode (:func:`pair_ops`),
    with the signatures of the entry points they name."""

    density: object  # density / density_spill
    momentum: object  # accel, or accel_drho in continuity mode (+ _spill)
    energy: object  # energy / energy_spill
    normals: object  # st_normals / st_normals_spill
    force: object  # st_force / st_force_spill
    surface_tension: object  # surface_tension / surface_tension_spill


def pair_ops(use_kernels, spill, continuity):
    """The pair passes a step runs: the two-tier ``*_spill`` entry points
    with ``spill``, the single-tier ones otherwise; the momentum pass
    fused with drho/dt (``accel_drho``) in continuity mode; the kernels'
    entry points with ``use_kernels``, their ``*_plain`` versions
    otherwise."""
    suffix = ("_spill" if spill else "") + ("" if use_kernels else "_plain")
    names = globals()
    return PairOps(*(names[n + suffix] for n in (
        "density", "accel_drho" if continuity else "accel", "energy",
        "st_normals", "st_force", "surface_tension")))


# --------------------------------------------------------------------------
# per-slot results to particle rows (the finish of every step)
# --------------------------------------------------------------------------

#: columns a row of :func:`slot_rows` may have (``csrc/slot_rows.cu``)
MAX_ROW_COLUMNS = 16


class CellMap(NamedTuple):
    """Where a cell id of a cell list lies in the pair passes' planes:
    cell ``c = (ix, iy, iz)`` of the cell list's grid is cell ``ix
    plane_ext + iy nz_ext + iz + offset`` of the planes, clamped into
    their ``n_ext`` cells (``same``: the grids share ny and nz, so that is
    ``c + offset``)."""

    plane_in: int
    nz_in: int
    plane_ext: int
    nz_ext: int
    offset: int
    n_ext: int
    same: bool


@functools.lru_cache(maxsize=256)
def cell_map(dims, ext_dims=None, offset=(0, 0, 0)):
    """The :class:`CellMap` of a cell list on the grid ``dims`` whose cell
    ``(0, 0, 0)`` is cell ``offset`` of the planes' grid ``ext_dims``
    (default: the same grid): the core block of an extended grid, or a
    slab's extended range (a negative x offset)."""
    ext = tuple(dims if ext_dims is None else ext_dims)
    plane_ext, nz_ext = ext[1] * ext[2], ext[2]
    return CellMap(
        plane_in=dims[1] * dims[2], nz_in=dims[2], plane_ext=plane_ext,
        nz_ext=nz_ext,
        offset=offset[0] * plane_ext + offset[1] * nz_ext + offset[2],
        n_ext=ext[0] * plane_ext,
        same=(dims[1], dims[2]) == (ext[1], ext[2]),
    )


def _columns(tier):
    """A tier's column sources as ``[E, K]`` planes, the sources' columns
    in order (a source is ``[E, K]`` or ``[E, K, m]``)."""
    return [p for src in tier
            for p in ((src,) if src.dim() == 2 else src.unbind(-1))]


def slot_rows_plain(tiers, fill, order, cid, slot, cmap, row0=None,
                    row1=None, n_rows=None, out=None):
    """The twin of ``slot_rows_kernel`` in plain torch ops (the CPU's
    path, and a plain step's on any device): the tiers' columns
    concatenated into one per-slot bundle ``[E, kt, F]``, one gather of
    each row's slot (a dropped row, slot ``>= kt``, takes ``fill``) and
    the rows written to their particle rows of ``out``.  Arguments as
    :func:`_rows`; returns ``(out, window rows)``."""
    bundle = torch.cat(
        [torch.stack(_columns(t), dim=-1) for t in tiers], dim=1)
    kt, f = bundle.shape[1], bundle.shape[2]
    n = order.shape[0]
    fill_t = torch.tensor(fill, dtype=bundle.dtype, device=bundle.device)
    if row0 is None:
        c, s = cid[:n], slot[:n]
    else:
        rows = row0 + torch.arange(n_rows, device=order.device)
        keep = rows < torch.clamp(row1, max=n)  # the window's own rows
        rows = rows[keep]
        c, s = cid[rows], slot[rows]
    if cmap.same:
        e = c
    else:
        ix = torch.div(c, cmap.plane_in, rounding_mode="floor")
        rem = c - ix * cmap.plane_in
        iy = torch.div(rem, cmap.nz_in, rounding_mode="floor")
        e = ix * cmap.plane_ext + iy * cmap.nz_ext + (rem - iy * cmap.nz_in)
    e = torch.clamp(e + cmap.offset, 0, cmap.n_ext - 1)
    vals = bundle.reshape(-1, f)[e * kt + torch.clamp(s, 0, kt - 1)]
    vals = torch.where((s < kt)[:, None], vals, fill_t)
    if out is None:
        out = vals.new_empty((n, f))
    if row0 is None:
        out[order] = vals  # the inverse permutation as a scatter
        return out, vals
    out[order[rows]] = vals
    win = fill_t.expand(n_rows, f).clone()
    win[keep] = vals
    return out, win


def _rows(tiers, fill, order, cid, slot, cmap, row0=None, row1=None,
          n_rows=None, out=None, emit=False, plain=False):
    """Sorted rows ``row0 + i`` (``row0`` a 0-d int64 tensor, or none:
    every row), ``i < n_rows``, before ``row1`` (a 0-d int64 tensor, with
    ``row0``) and ``n``, to their particle rows of ``out [n, F]`` (made
    when ``None``); ``cid``/``slot`` hold each sorted row's cell id and
    slot, ``order`` the sort.  Returns ``(out, window rows [n_rows, F] or
    None)``; with ``emit`` the window rows are returned (the fill row
    past ``row1``).  CUDA tensors launch ``slot_rows_kernel`` unless
    ``plain``; otherwise :func:`slot_rows_plain` runs."""
    if len(tiers) not in (1, 2):
        raise ValueError("slot_rows takes 1 or 2 tiers; got %d" % len(tiers))
    if len(fill) > MAX_ROW_COLUMNS:
        raise ValueError("slot_rows takes at most %d columns; got %d"
                         % (MAX_ROW_COLUMNS, len(fill)))
    if (row0 is None) != (row1 is None):
        raise ValueError("a window of slot_rows needs its first and its "
                         "end row")
    if plain or _on_cpu(order, cid, slot):
        out, win = slot_rows_plain(tiers, fill, order, cid, slot, cmap, row0,
                                   row1, n_rows, out)
        return out, win if emit else None
    return _launch_rows(tiers, fill, order, cid, slot, cmap, row0, row1,
                        n_rows, out, emit)


def _plane_pointers(tier, e, k, dev):
    """The plane pointers of one tier's column sources: float32 on
    ``dev``, each ``[E, K]`` contiguous or ``[E, K, m]`` laid out as ``m``
    such planes (a permuted ``[m, E, K]`` SoA output)."""
    ptrs = []
    for src in tier:
        planes = src.dim() == 2 and src.is_contiguous() or (
            src.dim() == 3 and src.stride(0) == k and src.stride(1) == 1)
        if (src.dtype != torch.float32 or src.device != dev
                or tuple(src.shape[:2]) != (e, k) or not planes):
            raise ValueError(
                "slot_rows column sources must be float32 [%d, %d] planes "
                "(or [%d, %d, m] views of [m, %d, %d]) on %s; got %s %s "
                "strides %s on %s"
                % (e, k, e, k, e, k, dev, src.dtype, tuple(src.shape),
                   src.stride(), src.device))
        if src.dim() == 2:
            ptrs.append(src.data_ptr())
            continue
        base, step = src.data_ptr(), src.stride(2) * 4
        ptrs.extend(base + j * step for j in range(src.shape[2]))
    return ptrs


def _launch_rows(tiers, fill, order, cid, slot, cmap, row0, row1, n_rows,
                 out, emit):
    """One launch of ``slot_rows_kernel``, counted in
    :data:`row_launch_counts` (arguments as :func:`_rows`)."""
    lib = _build.load()
    dev = order.device
    e, k = tiers[0][0].shape[:2]
    if e != cmap.n_ext:
        raise ValueError("slot_rows planes have %d cells; the cell map %d"
                         % (e, cmap.n_ext))
    ptrs = [_plane_pointers(t, e, k, dev) for t in tiers]
    f = len(ptrs[0])
    if any(len(p) != f for p in ptrs) or len(fill) != f:
        raise ValueError(
            "slot_rows tiers and fill must give the same columns; got %s and "
            "%d" % ([len(p) for p in ptrs], len(fill)))
    window = () if row0 is None else (row0, row1)
    for t in (order, cid, slot) + window:
        if t.dtype != torch.int64 or t.device != dev or not t.is_contiguous():
            raise ValueError("slot_rows indices must be contiguous int64 on "
                             "%s" % dev)
    n = order.shape[0]
    if (cid.shape != slot.shape or cid.dim() != 1 or cid.shape[0] < n
            or any(t.dim() != 0 for t in window)):
        raise ValueError(
            "slot_rows needs %d sorted cell ids and slots (and a 0-d first "
            "and end row for a window); got %s and %s"
            % (n, tuple(cid.shape), tuple(slot.shape)))
    if n_rows is None:
        n_rows = n
    if out is None:
        out = torch.empty((n, f), dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (n, f)
          or not out.is_contiguous() or out.device != dev):
        raise ValueError("slot_rows out must be contiguous float32 [%d, %d] "
                         "on %s" % (n, f, dev))
    win = (torch.empty((n_rows, f), dtype=torch.float32, device=dev) if emit
           else None)
    arr = ctypes.c_void_p * MAX_ROW_COLUMNS
    tier_b = ptrs[1] if len(ptrs) == 2 else ptrs[0]
    window_ptrs = [t.data_ptr() for t in window] or [None, None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_slot_rows(
            cid.data_ptr(), slot.data_ptr(), order.data_ptr(),
            *window_ptrs, n_rows, n, arr(*ptrs[0]), arr(*tier_b),
            (ctypes.c_float * MAX_ROW_COLUMNS)(*fill), f, k, len(tiers),
            cmap.plane_in, cmap.nz_in, cmap.plane_ext, cmap.nz_ext,
            cmap.offset, cmap.n_ext, out.data_ptr(),
            None if win is None else win.data_ptr(), stream)
    _raise_on(lib, rc, "slot_rows")
    row_launch_counts["slot_rows"] += int(n_rows > 0)
    return out, win


def slot_rows(tiers, fill, cells, dims, ext_dims=None, offset=(0, 0, 0),
              plain=False):
    """Each particle's row of the pair passes' per-slot results: ``[n,
    F]`` float32 in the particle order of ``cells`` (a
    :class:`~tpgsd_torch.sph.cells.CellList`: its ``order``, ``cid`` and
    ``slot``).

    ``tiers`` is one list of column sources a tier (the single tier, or
    the two of the spill layout, slots ``< K`` and ``K .. 2K - 1``), each
    source a float32 ``[E, K]`` plane or ``[E, K, m]`` (``m`` columns on
    the last axis, such as a ``[C, K, F]`` view of the momentum pass's
    SoA output); a row's columns are its tier's sources' columns in
    order.  ``fill`` holds the ``F`` values of a particle whose slot lies
    past the tiers (dropped by the cell list, or a dead slot of a
    decomposed step): the sentinel row of the dense layout.  ``dims`` is
    the grid of the cell ids; ``ext_dims`` and ``offset`` the planes'
    grid and the cell of it that cell ``(0, 0, 0)`` is (default: the same
    grid; a decomposed step's core block in its extended grid).

    CUDA tensors launch ``slot_rows_kernel`` once, counted in
    :data:`row_launch_counts`; CPU tensors, and ``plain`` (a step built
    with ``use_kernels=False``), take :func:`slot_rows_plain`.  Both copy
    the same values: the result is the one of concatenating the tiers and
    columns with the sentinel row and gathering through the sort's
    inverse permutation (:func:`~tpgsd_torch.sph.cells.
    gather_from_cells`)."""
    return _rows(tiers, tuple(fill), cells.order, cells.cid, cells.slot,
                 cell_map(tuple(dims), ext_dims and tuple(ext_dims),
                          tuple(offset)), plain=plain)[0]


def window_rows(tiers, fill, out, order, cid, slot, p0, p1, n_rows, dims,
                ext_dims, offset, emit=False, plain=False):
    """The slab step's form of :func:`slot_rows`: the window of sorted rows
    ``p0 .. p0 + n_rows - 1`` (``p0`` a 0-d int64 device tensor), those
    before ``p1`` (the next slab's first row, a 0-d int64 device tensor)
    each written to its particle row of ``out [n, F]``; rows from ``p1``
    on are the later slabs' own and are not written.  The planes' grid
    ``ext_dims`` is the slab's extended range, cell ``offset`` of it the
    domain's cell ``(0, 0, 0)``, and a row's cell is clamped into it.
    Returns the window's rows ``[n_rows, F]`` in window order with
    ``emit`` (the slab's frame rows, the fill row from ``p1`` on), else
    ``None``; ``plain`` as in :func:`slot_rows`."""
    return _rows(tiers, tuple(fill), order, cid, slot,
                 cell_map(tuple(dims), tuple(ext_dims), tuple(offset)),
                 row0=p0, row1=p1, n_rows=int(n_rows), out=out, emit=emit,
                 plain=plain)[1]
