"""Pair passes of the two-tier (spill) step: hand-written CUDA kernels and
their plain versions (torch counterpart of the spill entry points of
``tpgsd.sph.pallas_ops``).

Three CUDA kernels (``tpgsd_torch/csrc/sph_pairs.cu``) replace the six
packed Pallas kernels of the spill step (summation and continuity
density mode):

========================  ==============================================
wrapper (role)            replaces (tpgsd/sph/pallas_ops.py)
========================  ==============================================
density_pairs (self)      ``_density_kernel_packed`` (AA and BB passes)
density_pairs (cross)     ``_density_kernel_packed_cross`` (AB and BA)
accel_pairs (self)        ``_accel_kernel_packed`` (AA and BB)
accel_pairs (cross)       ``_accel_kernel_packed_cross`` (AB and BA)
accel_drho_pairs (self)   ``_accel_drho_kernel_packed`` (AA and BB)
accel_drho_pairs (cross)  ``_accel_drho_kernel_packed_cross`` (AB and BA)
========================  ==============================================

A self pass and a cross pass differ only in which tier holds the centres
and which the neighbours, so each wrapper takes both tiers explicitly.
What bounds the kernels on the H100 is the pair arithmetic and the L2
re-reads of each neighbour cell; the design (one warp per cell, the
neighbour cell staged in shared memory, sums in registers, warp-vote
skips of empty cells) is described at the top of the CUDA source.

Dispatch rule: a tensor on the CPU takes the plain version; a CUDA
tensor launches the kernel or raises.  There is no fallback.  Each
wrapper adds one to :data:`launch_counts` where it launches its kernel.
"""

import torch

from .. import _build
from .kernels import WendlandC2, kernel_code
from .step import (
    _accel_blocks,
    _accel_drho_blocks,
    _density_blocks,
    neighbor_index,
)

#: slots per cell the CUDA kernels take (each lane owns <= 2 centres)
MAX_CAPACITY = 64

#: kernel launches per role since the last :func:`reset_launch_counts`
launch_counts = {
    "density_self": 0,
    "density_cross": 0,
    "accel_self": 0,
    "accel_cross": 0,
    "accel_drho_self": 0,
    "accel_drho_cross": 0,
}


def reset_launch_counts():
    for key in launch_counts:
        launch_counts[key] = 0


def spill_supported(grid):
    """True when the CUDA pair kernels take ``grid.capacity`` slots per
    cell (both tiers of the spill layout have that capacity)."""
    return 1 <= grid.capacity <= MAX_CAPACITY


def accel_drho_supported(grid):
    """True when the fused momentum + continuity kernel takes
    ``grid.capacity`` (the same capacities as the other pair kernels)."""
    return spill_supported(grid)


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


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
    all contiguous, ``1 <= K <= MAX_CAPACITY``."""
    c, k = grid.n_cells, grid.capacity
    if not spill_supported(grid):
        raise ValueError(
            "the CUDA pair kernels take 1 <= capacity <= %d; capacity %d "
            "needs the lane-padded kernels (ROADMAP queue 2, kernels 7-9)"
            % (MAX_CAPACITY, k)
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


def _launch_density(xc, mc, xn, mn, grid, params, kernel, role):
    lib = _build.load()
    _check_launch(grid, (xc, xn), (), (mc, mn))
    code = kernel_code(kernel)
    inv2h, invh2, mfold = _density_folds(params, kernel)
    h = params.h
    supp2 = (kernel.support_scale * h) ** 2
    out = torch.empty_like(mc, dtype=torch.float32)
    nx, ny, nz = grid.dims
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_density_pairs(
            xc.data_ptr(), mc.data_ptr(), xn.data_ptr(), mn.data_ptr(),
            out.data_ptr(), nx, ny, nz, grid.capacity, code,
            inv2h, invh2, mfold, h, kernel._sigma(h, params.dim), supp2,
            stream,
        )
    _raise_on(lib, rc, "density_pairs")
    launch_counts["density_" + role] += 1
    return out


def _launch_accel(xc, vc, rhoc, ptc, mc, xn, vn, rhon, ptn, mn, grid,
                  params, kernel, role, delta_sph=None):
    """One launch of the momentum kernel -> ``[3, C, K]``, or with
    ``delta_sph`` (a number, 0 included) of its fused momentum +
    continuity instance -> ``[4, C, K]``, counted as ``accel_<role>`` or
    ``accel_drho_<role>``."""
    lib = _build.load()
    _check_launch(grid, (xc, vc, xn, vn), (rhoc, ptc, rhon, ptn), (mc, mn))
    code = kernel_code(kernel)
    _, cv = _accel_folds(params, kernel)
    drho = delta_sph is not None
    folds = _drho_folds(params, kernel, delta_sph) if drho else (0.0,) * 4
    name = "accel_drho" if drho else "accel"
    h = params.h
    h2eps = params.eps * h * h
    supp2 = (kernel.support_scale * h) ** 2
    n_out = 4 if drho else 3
    out = xc.new_empty((n_out,) + tuple(mc.shape))
    nx, ny, nz = grid.dims
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpgsd_accel_pairs(
            xc.data_ptr(), vc.data_ptr(), rhoc.data_ptr(), ptc.data_ptr(),
            mc.data_ptr(), xn.data_ptr(), vn.data_ptr(), rhon.data_ptr(),
            ptn.data_ptr(), mn.data_ptr(), out.data_ptr(), n_out,
            nx, ny, nz, grid.capacity, code,
            0.5 / h, h, kernel._sigma(h, params.dim), h2eps, cv, supp2,
            *folds, stream,
        )
    _raise_on(lib, rc, name + "_pairs")
    launch_counts["%s_%s" % (name, role)] += 1
    return out


# --------------------------------------------------------------------------
# per-pass wrappers and their plain versions
# --------------------------------------------------------------------------


def density_pairs_plain(xc, mc, xn, mn, grid, params, kernel=WendlandC2):
    """Plain version of :func:`density_pairs`."""
    nbr = neighbor_index(grid, xc.device)
    return _density_blocks(xc, mc, xn, mn, nbr, params, kernel)


def density_pairs(xc, mc, xn, mn, grid, params, kernel=WendlandC2,
                  cross=False):
    """Density contribution ``[C, K]`` to the centres of one tier
    (``xc [3, C, K]``, live mask ``mc [C, K]``) from the neighbours of a
    tier (``xn``, ``mn``): ``m_i * mass * sum_j m_j W(r_ij)`` over the
    27 neighbour cells.  ``cross`` names the role (centres and
    neighbours from different tiers) for the launch count."""
    if _on_cpu(xc, mc, xn, mn):
        return density_pairs_plain(xc, mc, xn, mn, grid, params, kernel)
    return _launch_density(
        xc, mc, xn, mn, grid, params, kernel, "cross" if cross else "self"
    )


def accel_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid,
                      params, kernel=WendlandC2):
    """Plain version of :func:`accel_pairs`."""
    nbr = neighbor_index(grid, xc.device)
    return _accel_blocks(
        xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params, kernel
    )


def accel_pairs(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                kernel=WendlandC2, cross=False):
    """Pressure + viscosity acceleration ``[3, C, K]`` of the centres of
    one tier from the neighbours of a tier (positions and velocities
    ``[3, C, K]``, density, pressure and live mask ``[C, K]``).  Dead
    slots must carry a positive density (the step sets ``rho0``)."""
    if _on_cpu(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn):
        return accel_pairs_plain(
            xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params, kernel
        )
    return _launch_accel(
        xc, vc, rhoc, pressure_plane(rhoc, pc, params, kernel), mc,
        xn, vn, rhon, pressure_plane(rhon, pn, params, kernel), mn,
        grid, params, kernel, "cross" if cross else "self",
    )


def accel_drho_pairs_plain(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid,
                           params, kernel=WendlandC2, delta_sph=0.1):
    """Plain version of :func:`accel_drho_pairs`."""
    nbr = neighbor_index(grid, xc.device)
    return _accel_drho_blocks(
        xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, nbr, params, kernel,
        delta_sph,
    )


def accel_drho_pairs(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params,
                     kernel=WendlandC2, delta_sph=0.1, cross=False):
    """Fused momentum + continuity pass ``[4, C, K]`` (acc_x, acc_y,
    acc_z, drho/dt) of the centres of one tier from the neighbours of a
    tier; operands as :func:`accel_pairs`.  ``delta_sph`` is the
    delta-SPH density-diffusion strength (0 = off).  Live densities must
    be floored at ``0.1 rho0`` and dead slots carry ``rho0`` (the step
    does both): the kernel floors the neighbour density of the diffusion
    term there, the plain version does not."""
    if _on_cpu(xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn):
        return accel_drho_pairs_plain(
            xc, vc, rhoc, pc, mc, xn, vn, rhon, pn, mn, grid, params, kernel,
            delta_sph,
        )
    return _launch_accel(
        xc, vc, rhoc, pressure_plane(rhoc, pc, params, kernel), mc,
        xn, vn, rhon, pressure_plane(rhon, pn, params, kernel), mn,
        grid, params, kernel, "cross" if cross else "self", delta_sph,
    )


# --------------------------------------------------------------------------
# the two-tier entry points (pallas_ops.density_spill / accel_spill /
# accel_drho_spill)
# --------------------------------------------------------------------------


def _two_tier(pairs, a, b):
    """``(AA + AB, BB + BA)``: the two-tier sums of one pair pass
    ``pairs(centres, neighbours, role)`` over tiers ``a`` and ``b`` (as
    ``pallas_ops.density_spill`` / ``accel_spill`` sum them)."""
    return (
        pairs(a, a, "self") + pairs(a, b, "cross"),
        pairs(b, b, "self") + pairs(b, a, "cross"),
    )


def _density_tiers(x_a, mask_a, x_b, mask_b, grid):
    c = grid.n_cells
    return (x_a, mask_a[:c]), (x_b, mask_b[:c])


def density_spill(dense_x_a, mask_a, dense_x_b, mask_b, grid, params,
                  kernel=WendlandC2):
    """Two-tier SPH density: main tier A (slots < K) + spill tier B, SoA
    positions ``[3, C, K]`` and masks ``[C(+1), K]``.  Returns ``(rho_a,
    rho_b)``, each ``[C, K]``: ``rho_a = AA + AB``, ``rho_b = BB + BA``.
    CPU tensors take :func:`density_spill_plain`; CUDA tensors launch the
    density kernel four times."""
    a, b = _density_tiers(dense_x_a, mask_a, dense_x_b, mask_b, grid)
    if _on_cpu(*a, *b):
        return density_spill_plain(
            dense_x_a, mask_a, dense_x_b, mask_b, grid, params, kernel
        )
    return _two_tier(
        lambda cen, nbr, role: _launch_density(
            *cen, *nbr, grid, params, kernel, role
        ),
        a, b,
    )


def density_spill_plain(dense_x_a, mask_a, dense_x_b, mask_b, grid, params,
                        kernel=WendlandC2):
    """Plain version of :func:`density_spill` (any device)."""
    a, b = _density_tiers(dense_x_a, mask_a, dense_x_b, mask_b, grid)
    return _two_tier(
        lambda cen, nbr, role: density_pairs_plain(
            *cen, *nbr, grid, params, kernel
        ),
        a, b,
    )


def _accel_two_tier(a, b, grid, params, kernel, delta_sph, plain):
    """Two-tier sums ``(AA + AB, BB + BA)`` of the momentum pass, or with
    ``delta_sph`` (a number, 0 included) of the fused momentum +
    continuity pass, over tiers ``a`` and ``b`` (each ``(x, v, rho, p,
    mask)``), as ``[C, K, F]`` views of the SoA sums.  CPU tensors, and
    ``plain``, take the plain pair passes; CUDA tensors launch the kernel
    four times, with each tier's pressure plane folded once for its two
    passes."""
    c = grid.n_cells
    a, b = (t[:2] + tuple(f[:c] for f in t[2:]) for t in (a, b))
    drho = delta_sph is not None
    if plain or _on_cpu(*a, *b):
        def pairs(cen, nbr, role):
            if drho:
                return accel_drho_pairs_plain(
                    *cen, *nbr, grid, params, kernel, delta_sph
                )
            return accel_pairs_plain(*cen, *nbr, grid, params, kernel)
    else:
        a, b = (
            t[:3] + (pressure_plane(t[2], t[3], params, kernel),) + t[4:]
            for t in (a, b)
        )

        def pairs(cen, nbr, role):
            return _launch_accel(
                *cen, *nbr, grid, params, kernel, role, delta_sph
            )

    out_a, out_b = _two_tier(pairs, a, b)
    return out_a.permute(1, 2, 0), out_b.permute(1, 2, 0)


def accel_spill(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2,
):
    """Two-tier SPH acceleration, the counterpart of
    :func:`density_spill`.  Returns ``(acc_a, acc_b)``, each ``[C, K,
    3]`` (views of the SoA sums): ``acc_a = AA + AB``, ``acc_b = BB +
    BA``.  CPU tensors take :func:`accel_spill_plain`; CUDA tensors
    launch the acceleration kernel four times."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, None, plain=False,
    )


def accel_spill_plain(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2,
):
    """Plain version of :func:`accel_spill` (any device)."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, None, plain=True,
    )


def accel_drho_spill(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, delta_sph=0.1,
):
    """Two-tier fused momentum + continuity pass (continuity-density mode
    on the spill layout), the drho counterpart of :func:`accel_spill`.
    Returns ``(out4_a, out4_b)``, each ``[C, K, 4]`` (views of the SoA
    sums) with columns acc_x, acc_y, acc_z, drho/dt: ``out4_a = AA + AB``,
    ``out4_b = BB + BA``.  CPU tensors take :func:`accel_drho_spill_plain`;
    CUDA tensors launch the fused kernel four times."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, delta_sph, plain=False,
    )


def accel_drho_spill_plain(
    dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a,
    dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b,
    grid, params, kernel=WendlandC2, delta_sph=0.1,
):
    """Plain version of :func:`accel_drho_spill` (any device)."""
    return _accel_two_tier(
        (dense_x_a, dense_v_a, dense_rho_a, dense_p_a, mask_a),
        (dense_x_b, dense_v_b, dense_rho_b, dense_p_b, mask_b),
        grid, params, kernel, delta_sph, plain=True,
    )
