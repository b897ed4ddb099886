"""Plain weakly-compressible SPH step in summation-density mode.

The formulation the configurations state (WCSPH, Wendland C2 kernel of
support 2h, Tait equation of state, Monaghan artificial viscosity,
symplectic Euler, reflective damped walls), written from the equations
with plain tensor operations: a sort of the particles by cell of the
benchmark's own grid, candidate neighbours from the 27 cells around each
particle, and the pairs within the support.  Nothing of the program's
layout (tiers, slots, capacities) appears here.

``dtype`` sets the precision of every operation: float64 for the
reference, bfloat16 for the control that ``calibrate.py`` reads.
"""

import math

import torch

#: queries per block of the candidate search; bounds its memory at about
#: ``BLOCK * 27 * max_count`` candidates
BLOCK = 1 << 15


class Params:
    """The step's constants from a configuration's ``physics`` and
    ``grid`` groups (Python floats)."""

    def __init__(self, cfg):
        ph, gr = cfg["physics"], cfg["grid"]
        self.mass = float(ph["mass"])
        self.h = float(ph["h"])
        self.dt = float(ph["dt"])
        self.rho0 = float(ph["rho0"])
        self.c0 = float(ph["c0"])
        self.gamma = float(ph["gamma"])
        self.alpha = float(ph["alpha"])
        self.eps = float(ph["eps"])
        self.gravity = tuple(float(g) for g in ph["gravity"])
        self.wall_damping = float(ph["wall_damping"])
        self.velocity_damping = float(ph["velocity_damping"])
        self.support = 2.0 * self.h
        self.lo = tuple(float(v) for v in gr["lo"])
        self.hi = tuple(float(v) for v in gr["hi"])


class Binning:
    """Particles sorted by cell of a grid of cells at least the support
    wide: ``order``, each cell's first sorted row and count."""

    def __init__(self, x, params):
        dev = x.device
        lo = torch.tensor(params.lo, dtype=torch.float64, device=dev)
        hi = torch.tensor(params.hi, dtype=torch.float64, device=dev)
        dims = torch.floor((hi - lo) / params.support).to(torch.int64)
        dims = torch.clamp(dims, min=1)
        self.dims = [int(d) for d in dims]
        self.cell = (hi - lo) / dims
        self.lo = lo
        self.idx3 = self.cell_index(x)
        nx, ny, nz = self.dims
        cid = (self.idx3[:, 0] * ny + self.idx3[:, 1]) * nz + self.idx3[:, 2]
        sorted_cid, self.order = torch.sort(cid, stable=True)
        n_cells = nx * ny * nz
        cells = torch.arange(n_cells + 1, device=dev)
        bounds = torch.searchsorted(sorted_cid, cells)
        self.starts = bounds[:-1]
        self.counts = bounds[1:] - bounds[:-1]
        self.max_count = int(self.counts.max()) if n_cells else 0

    def cell_index(self, x):
        idx = torch.floor((x.to(torch.float64) - self.lo) / self.cell)
        idx = idx.to(torch.int64)
        top = torch.tensor(self.dims, device=x.device) - 1
        return torch.minimum(torch.clamp(idx, min=0), top)


_OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]


def pairs_within(query, x, binning, radius, block=BLOCK):
    """Yields ``(qi, j)``: for each block of the particle indices
    ``query``, the positions in ``query`` and the particle indices of
    every pair closer than ``radius`` (the particle itself included),
    found from the 27 cells around each query particle.  Distances are
    taken in float64."""
    dev = x.device
    nx, ny, nz = binning.dims
    top = torch.tensor([nx, ny, nz], device=dev)
    offs = torch.tensor(_OFFSETS, device=dev)  # [27, 3]
    slots = torch.arange(max(binning.max_count, 1), device=dev)
    r2max = radius * radius
    for b0 in range(0, query.numel(), block):
        q = query[b0:b0 + block]
        c3 = binning.idx3[q][:, None, :] + offs  # [B, 27, 3]
        inside = ((c3 >= 0) & (c3 < top)).all(dim=-1)
        c3 = torch.where(inside[..., None], c3, 0)
        cid = (c3[..., 0] * ny + c3[..., 1]) * nz + c3[..., 2]
        start = binning.starts[cid]
        count = torch.where(inside, binning.counts[cid], 0)
        live = slots < count[..., None]  # [B, 27, S]
        rows = torch.where(live, start[..., None] + slots, 0)
        bi, ci, si = torch.nonzero(live, as_tuple=True)
        j = binning.order[rows[bi, ci, si]]
        d = x[q[bi]].to(torch.float64) - x[j].to(torch.float64)
        near = (d * d).sum(dim=-1) < r2max
        yield b0 + bi[near], j[near]


def kernel_w(r, h):
    """Wendland C2 in 3-D, support 2h."""
    q = r / h
    t = torch.clamp(1.0 - 0.5 * q, min=0.0)
    return (21.0 / (16.0 * math.pi * h ** 3)) * t ** 4 * (2.0 * q + 1.0)


def kernel_dw_over_r(r, h):
    """``(1/r) dW/dr`` of :func:`kernel_w`, finite at 0."""
    q = r / h
    t = torch.clamp(1.0 - 0.5 * q, min=0.0)
    return (21.0 / (16.0 * math.pi * h ** 3)) * (-5.0) * t ** 3 / (h * h)


def tait(rho, params):
    b = params.rho0 * params.c0 ** 2 / params.gamma
    return b * ((rho / params.rho0) ** params.gamma - 1.0)


def density(rows, x, binning, params, dtype):
    """Summation density of the particles ``rows``, floored at
    ``0.1 rho0`` as the configuration states -> ``[len(rows)]``."""
    out = torch.zeros(rows.numel(), dtype=dtype, device=x.device)
    for qi, j in pairs_within(rows, x, binning, params.support):
        d = x[rows[qi]].to(dtype) - x[j].to(dtype)
        r = torch.sqrt((d * d).sum(dim=-1))
        out.index_add_(0, qi, params.mass * kernel_w(r, params.h))
    return torch.clamp(out, min=0.1 * params.rho0)


def acceleration(rows, x, v, rho_of, p_of, binning, params, dtype):
    """Pressure, viscosity and gravity acceleration of the particles
    ``rows``; ``rho_of`` / ``p_of`` give any particle's density and
    pressure by particle index -> ``[len(rows), 3]``."""
    h2eps = params.eps * params.h * params.h
    out = torch.zeros((rows.numel(), 3), dtype=dtype, device=x.device)
    for qi, j in pairs_within(rows, x, binning, params.support):
        i = rows[qi]
        dx = x[i].to(dtype) - x[j].to(dtype)
        dv = v[i].to(dtype) - v[j].to(dtype)
        r2 = (dx * dx).sum(dim=-1)
        r = torch.sqrt(r2)
        dwr = kernel_dw_over_r(r, params.h)
        rho_i, rho_j = rho_of(i), rho_of(j)
        press = p_of(i) / rho_i ** 2 + p_of(j) / rho_j ** 2
        vdotx = (dv * dx).sum(dim=-1)
        mu = vdotx / (r2 + h2eps)
        visc = -params.alpha * params.c0 * params.h * mu
        pi = torch.where(vdotx < 0, visc / (0.5 * (rho_i + rho_j)),
                         torch.zeros((), dtype=dtype, device=x.device))
        scale = -params.mass * (press + pi) * dwr
        out.index_add_(0, qi, scale[:, None] * dx)
    return out + torch.tensor(params.gravity, dtype=dtype, device=x.device)


def walls(x_drift, v_kick, params, bounce):
    """The walls on each component: where ``bounce``, reflected and its
    velocity reversed and damped; clipped into the box -> ``(x, v)``."""
    lo = torch.tensor(params.lo, dtype=x_drift.dtype, device=x_drift.device)
    hi = torch.tensor(params.hi, dtype=x_drift.dtype, device=x_drift.device)
    x = torch.where(bounce & (x_drift < lo), 2.0 * lo - x_drift, x_drift)
    x = torch.where(bounce & (x_drift > hi), 2.0 * hi - x, x)
    x = torch.minimum(torch.maximum(x, lo), hi)
    v = torch.where(bounce, -params.wall_damping * v_kick, v_kick)
    return x, v


def integrate(x, v, acc, params, dtype):
    """Kick, drift, then the walls -> ``(x, v, x_drift, v_kick)``;
    ``x_drift`` / ``v_kick`` are the state before the walls act."""
    lo = torch.tensor(params.lo, dtype=dtype, device=x.device)
    hi = torch.tensor(params.hi, dtype=dtype, device=x.device)
    v_kick = (v.to(dtype) + params.dt * acc) * params.velocity_damping
    x_drift = x.to(dtype) + params.dt * v_kick
    x_new, v_new = walls(x_drift, v_kick, params,
                         (x_drift < lo) | (x_drift > hi))
    return x_new, v_new, x_drift, v_kick


def step_rows(x, v, rows, params, dtype=torch.float64):
    """One step of the particles ``rows`` from the state ``(x, v)`` of
    all particles: ``{"rho", "p", "x", "v", "x_drift", "v_kick", "dv"}``
    of those rows, in ``dtype``.  ``rho`` and ``p`` are the density and
    pressure at the step's input positions; ``x_drift`` and ``v_kick``
    the state before the walls act, ``dv`` the change of velocity by the
    forces."""
    binning = Binning(x, params)
    # the densities every row's pairs read: the rows and their neighbours
    need = torch.cat([j for _, j in pairs_within(rows, x, binning,
                                                 params.support)] + [rows])
    need = torch.unique(need)
    rho_need = density(need, x, binning, params, dtype)
    p_need = tait(rho_need, params)

    def lookup(values):
        return lambda idx: values[torch.searchsorted(need, idx)]

    acc = acceleration(rows, x, v, lookup(rho_need), lookup(p_need),
                       binning, params, dtype)
    x_new, v_new, x_drift, v_kick = integrate(x[rows], v[rows], acc, params,
                                              dtype)
    pos = torch.searchsorted(need, rows.contiguous())
    return {"rho": rho_need[pos], "p": p_need[pos], "x": x_new, "v": v_new,
            "x_drift": x_drift, "v_kick": v_kick, "dv": params.dt * acc}
