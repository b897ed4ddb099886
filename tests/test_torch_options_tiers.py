"""The two-tier passes of the step's XSPH and Akinci surface-tension
options in the torch port: the plain two-tier passes against the
reference's jnp passes on its single tier of twice the capacity
(slot-identical to the two tiers side by side), closed and periodic;
and the ghost-halo route of the kernel wrappers (the plain passes on the
ghost grid, CPU tensors) against the wrapped-table route, on one tier up
to 64 slots and past them and on two tiers (the energy rate, which runs
on one tier only, on one tier).  The kernels meet the same passes on
the card (tests/test_torch_cuda.py).

Tolerances: rtol 1e-4, atol 1e-5 on each column scaled by its max (the
acceleration tolerance of tests/test_pallas_ops.py); the sums run in
another order in each implementation.
"""

import numpy
import pytest
import torch

import jax.numpy as jnp

from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph.cells import build_cells as ref_build_cells
from tpgsd.sph.cells import neighbor_table as ref_neighbor_table
from tpgsd.sph.cells import scatter_to_cells as ref_scatter_to_cells
from tpgsd.sph.kernels import WendlandC2 as RefWendlandC2
from tpgsd.sph.step import _cohesion_blocks as ref_cohesion_blocks
from tpgsd.sph.step import _mimage_of as ref_mimage_of
from tpgsd.sph.step import _xsph_blocks as ref_xsph_blocks
from tpgsd_torch.sph import ops, still_box
from tpgsd_torch.sph.cells import (
    build_cells,
    build_cells_spill,
    scatter_to_cells_soa,
    wrap_axes,
)
from tpgsd_torch.sph.convert import grid_from_reference, params_from_reference
from tpgsd_torch.sph.step import tait_pressure

GAMMA = 0.05  # the surface-tension strength of tests/test_spill.py


def _scaled_close(got, want, live, rtol=1e-4, atol=1e-5, err_msg=""):
    """``got`` against ``want`` on ``live`` slots, scaled by max|want|."""
    got, want = numpy.asarray(got)[live], numpy.asarray(want)[live]
    scale = float(numpy.abs(want).max())
    assert scale > 0.0, "the reference plane is zero"
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                                  atol=atol, err_msg=err_msg)


def _moving(x0, spacing, seed, v_scale=0.5, jitter=0.05):
    rng = numpy.random.default_rng(seed)
    x = x0 + (jitter * spacing) * rng.standard_normal(x0.shape)
    v = v_scale * rng.standard_normal(x0.shape)
    return x.astype(numpy.float32), v.astype(numpy.float32)


def _finish(rho, mask, params):
    rho = torch.where(mask, torch.clamp(rho, min=0.1 * params.rho0), params.rho0)
    return rho, torch.where(mask, tait_pressure(rho, params), 0.0)


def _two_tier_case(periodic, k=24, n_side=10, seed=3):
    """The port's two tiers at K = 24 of a jittered, moving dam break
    (spill tier occupied) and the same input in the reference's
    single-tier 2K layout, slot-identical to the two tiers side by side;
    both carry the port's finished density."""
    db = ref_dam_break(n_side=n_side, capacity=k)
    x, v = _moving(numpy.asarray(db.state.x), db.params.h / 1.3, seed)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    c = grid.n_cells
    xv = torch.from_numpy(numpy.concatenate([x, v], 1))
    cells, sp = build_cells_spill(torch.from_numpy(x), grid, k)
    assert bool(sp.mask.any()) and int(cells.overflow) == 0
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    wrap = ops._wrapped(wrap_axes(grid, periodic))
    ma, mb = cells.mask[:c], sp.mask[:c]
    rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, params,
                                  wrap_axes=wrap)
    (ra, pa), (rb, pb) = _finish(rho[0], ma, params), _finish(rho[1], mb, params)

    grid2 = db.grid._replace(capacity=2 * k)
    cells2 = ref_build_cells(jnp.asarray(x), grid2)
    dense = ref_scatter_to_cells(jnp.asarray(xv.numpy()), cells2, grid2)
    live2 = numpy.asarray(cells2.mask)[:c]
    assert (live2[:, k:] == mb.numpy()).all()
    rho2 = numpy.concatenate([torch.cat([ra, rb], 1).numpy(),
                              numpy.full((1, 2 * k), params.rho0, numpy.float32)])
    return {
        "grid": grid, "params": params, "wrap": wrap, "k": k, "live2": live2,
        "a": (a[:3], a[3:], ra, pa, ma), "b": (b[:3], b[3:], rb, pb, mb),
        "ref": (dense[..., :3], dense[..., 3:], jnp.asarray(rho2), cells2.mask,
                ref_neighbor_table(grid2, periodic=periodic)),
        "ref_params": db.params, "mimage": ref_mimage_of(grid2, periodic),
    }


def _tiers_close(got, want, live2, k, err_msg):
    """Both tiers' ``[C, K(, F)]`` results against the reference's ``[C,
    2K(, F)]``, each column scaled by its max over both tiers."""
    got2 = numpy.concatenate([numpy.asarray(got[0]), numpy.asarray(got[1])], 1)
    want = numpy.asarray(want)
    if want.ndim == 2:
        _scaled_close(got2, want, live2, err_msg=err_msg)
        return
    for d in range(want.shape[-1]):
        _scaled_close(got2[..., d], want[..., d], live2,
                      err_msg="%s column %d" % (err_msg, d))


@pytest.mark.parametrize("periodic", [False, True], ids=["closed", "periodic"])
@pytest.mark.parametrize("pass_name", ["xsph", "surface_tension"])
def test_two_tier_passes_match_reference_at_2k(pass_name, periodic):
    s = _two_tier_case(periodic)
    grid, params, wrap, a, b = s["grid"], s["params"], s["wrap"], s["a"], s["b"]
    rx, rv, rrho, rmask, nbr = s["ref"]
    rparams, mimage = s["ref_params"], s["mimage"]
    if pass_name == "xsph":
        got = ops.accel_spill_plain(*a, *b, grid, params, wrap_axes=wrap,
                                    xsph=True)
        assert got[0].shape == (grid.n_cells, s["k"], 6)
        want = ref_xsph_blocks(rx, rv, rrho, rmask, nbr, rparams, RefWendlandC2,
                               32, mimage=mimage)
        got = tuple(g[..., 3:] for g in got)
    else:
        got = ops.surface_tension_spill_plain(
            a[0], a[2], a[4], b[0], b[2], b[4], grid, params, GAMMA,
            wrap_axes=wrap)
        want = ref_cohesion_blocks(rx, rrho, rmask, nbr, rparams, RefWendlandC2,
                                   32, GAMMA, mimage=mimage)
    _tiers_close(got, want, s["live2"], s["k"], pass_name)


def _periodic_box(capacity, seed=11):
    """A jittered periodic still box with N(0, 0.25) velocities: one tier
    at ``capacity`` (or both tiers at K = 24 when ``capacity`` is
    ``"spill"``), finished density and pressure from the wrapped-table
    route."""
    sc = still_box(n_side=9, capacity=48, device="cpu")
    x, v = _moving(sc.state.x.numpy(), sc.params.h / 1.3, seed)
    box = numpy.asarray(sc.box, numpy.float32)
    x = numpy.minimum(numpy.mod(x, box), numpy.nextafter(box, 0))
    params = sc.params
    xv = torch.from_numpy(numpy.concatenate([x, v], 1).astype(numpy.float32))
    wrap = ops._wrapped(wrap_axes(sc.grid, True))
    assert wrap == (True, True, True)
    if capacity == "spill":
        grid = sc.grid._replace(capacity=24)
        cells, sp = build_cells_spill(xv[:, :3].contiguous(), grid, 24)
        assert bool(sp.mask.any())
        c = grid.n_cells
        a = scatter_to_cells_soa(xv, cells, grid)
        b = scatter_to_cells_soa(xv, cells, grid, slot_base=24, capacity=24)
        ma, mb = cells.mask[:c], sp.mask[:c]
        rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, params,
                                      wrap_axes=wrap)
        tiers = ((a[:3], a[3:], *_finish(rho[0], ma, params), ma),
                 (b[:3], b[3:], *_finish(rho[1], mb, params), mb))
    else:
        grid = sc.grid._replace(capacity=capacity)
        cells = build_cells(xv[:, :3].contiguous(), grid)
        assert int(cells.overflow) == 0
        t = scatter_to_cells_soa(xv, cells, grid)
        m = cells.mask[: grid.n_cells]
        rho = ops.density_plain(t[:3], m, grid, params, wrap_axes=wrap)
        tiers = ((t[:3], t[3:], *_finish(rho, m, params), m),)
    return grid, params, wrap, tiers


@pytest.mark.parametrize(
    "pass_name, layout",
    [(p, lay) for p in ("xsph", "surface_tension", "energy")
     for lay in ("single", "wide", "spill")
     if (p, lay) != ("energy", "spill")],  # energy runs on one tier only
    ids=lambda v: v,
)
def test_ghost_route_matches_wrapped_table(pass_name, layout):
    """The wrappers' periodic route (ghost-cell halo, the plain passes on
    the ghost grid, interior rows selected back; the normals are selected
    back before the force pass expands them again) against the plain
    versions' wrapped neighbour table and minimum image, on CPU tensors.
    A force pass fed the ghost grid's own normals, whose halo cells have
    truncated neighbourhoods, fails this."""
    capacity = {"single": 48, "wide": 72, "spill": "spill"}[layout]
    grid, params, wrap, tiers = _periodic_box(capacity)
    ops.reset_launch_counts()
    if layout == "spill":
        a, b = tiers
        if pass_name == "xsph":
            got = ops.accel_spill(*a, *b, grid, params, wrap_axes=wrap, xsph=True)
            want = ops.accel_spill_plain(*a, *b, grid, params, wrap_axes=wrap,
                                         xsph=True)
        else:
            args = (a[0], a[2], a[4], b[0], b[2], b[4], grid, params, GAMMA)
            got = ops.surface_tension_spill(*args, wrap_axes=wrap)
            want = ops.surface_tension_spill_plain(*args, wrap_axes=wrap)
        pairs = [(g, w, t[4].numpy()) for g, w, t in zip(got, want, tiers)]
    else:
        (t,) = tiers
        if pass_name == "xsph":
            got = ops.accel(*t, grid, params, wrap_axes=wrap, xsph=True)
            want = ops.accel_plain(*t, grid, params, wrap_axes=wrap, xsph=True)
        elif pass_name == "surface_tension":
            args = (t[0], t[2], t[4], grid, params, GAMMA)
            got = ops.surface_tension(*args, wrap_axes=wrap)
            want = ops.surface_tension_plain(*args, wrap_axes=wrap)
        else:
            got = ops.energy(*t, grid, params, wrap_axes=wrap)
            want = ops.energy_plain(*t, grid, params, wrap_axes=wrap)
        if got.dim() == 3:  # SoA planes -> [C, K, F], as the spill views
            got, want = got.permute(1, 2, 0), want.permute(1, 2, 0)
        pairs = [(got, want, t[4].numpy())]
    for g, w, live in pairs:
        g, w = g.numpy(), w.numpy()
        if w.ndim == 2:
            _scaled_close(g, w, live)
        else:
            for d in range(w.shape[-1]):
                _scaled_close(g[..., d], w[..., d], live,
                              err_msg="%s column %d" % (pass_name, d))
    assert set(ops.launch_counts.values()) == {0}
