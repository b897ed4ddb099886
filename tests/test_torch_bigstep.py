"""The torch port's slab-sequential step (``tpgsd_torch.sph.bigstep``)
against the JAX package's (``tpgsd.sph.bigstep``, its jnp path) and
against the port's own global step, one test for each of
tests/test_bigstep.py, at its tolerances.

The slab step runs the global step's pair passes on one slab's extended
grid at a time, so against the global step it differs by the order of
float sums at most; the port's plain slab step reproduces the port's
plain global step bit for bit.  Window and cell overflow counts match
the reference exactly.
"""

import inspect

import jax
import numpy
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import hydrostatic_tank as ref_hydrostatic_tank
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_slab_step_fn as ref_make_slab_step_fn
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph import slab_init_density as ref_slab_init_density
from tpgsd.sph import still_box as ref_still_box
from tpgsd_torch.sph import (
    init_density,
    make_slab_step_fn,
    make_step_fn,
    slab_init_density,
)
from tpgsd_torch.sph.bigstep import slab_tiers
from tpgsd_torch.sph.cells import build_cells_spill, scatter_to_cells_soa
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)

CPU = "cpu"
#: capacity of the scenarios whose densest cell holds 27 particles (the
#: 10-particle dam break, the 8-particle still box): the reference's
#: tests allot 48 or 64 slots, whose extra slots hold only zeros, and a
#: plain pair pass costs K^2 a cell.  The overflow counts are held to 0
#: in both packages.
CAP = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the suite runs several
    test processes on the same cores, where each op's parallel region
    waits for descheduled threads (these steps are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _divisor(nx, want=2):
    for s in range(want, 0, -1):
        if nx % s == 0:
            return s
    return 1


def _port(sc, grid=None):
    """``(grid, params, state)`` of a JAX scenario in the port."""
    st = sc.state
    return (
        grid_from_reference(sc.grid if grid is None else grid),
        params_from_reference(sc.params),
        state_from_numpy(st.x, st.v, CPU, rho=st.rho),
    )


def _ref_state(state):
    """The port's state as the JAX package's."""
    rho = None if state.rho is None else jax.numpy.asarray(state.rho.numpy())
    return RefState(x=jax.numpy.asarray(state.x.numpy()),
                    v=jax.numpy.asarray(state.v.numpy()), rho=rho)


def _close(got, want, rtol, atol=0.0):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  rtol=rtol, atol=atol)


def test_make_slab_step_fn_defaults_to_the_card():
    sig = inspect.signature(make_slab_step_fn)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["use_kernels"].default == "auto"
    assert sig.parameters["spill"].default == "auto"


def test_slab_step_matches_global_step():
    db = ref_dam_break(n_side=10, capacity=CAP)
    assert db.grid.dims[0] % 3 == 0, db.grid.dims
    grid, params, state = _port(db)
    step_s = make_slab_step_fn(grid, params, n_slabs=3, device=CPU)
    assert step_s.resolved == {"use_kernels": False, "spill": False,
                               "density_mode": "summation"}
    ss, (rs, ps, os_, ws) = step_s(state)
    ref_s = jax.jit(ref_make_slab_step_fn(db.grid, db.params, n_slabs=3,
                                          use_pallas=False))
    rss, (rrs, _rps, ros, rws) = ref_s(db.state)
    sg, (rg, pg, og) = make_step_fn(grid, params, device=CPU)(state)

    assert int(ws) == int(rws) == 0
    assert int(os_) == int(ros) == int(og)
    for want_x, want_v, want_r in ((rss.x, rss.v, rrs), (sg.x, sg.v, rg)):
        _close(rs, want_r, rtol=2e-5, atol=1e-2)
        _close(ss.x, want_x, rtol=1e-5, atol=1e-7)
        _close(ss.v, want_v, rtol=2e-4, atol=2e-4)
    # the same pair passes on the same cells: the port's global step bit
    # for bit
    assert torch.equal(ss.x, sg.x) and torch.equal(ss.v, sg.v)
    assert torch.equal(rs, rg) and torch.equal(ps, pg)


def test_slab_step_multiple_steps_stay_in_lockstep():
    # wall-free dynamics, as the reference's test: a perturbed zero-gravity
    # box runs 5 steps of pair math with no particle touching a wall
    sc = ref_still_box(n_side=8, capacity=CAP)
    amp = 0.02 * sc.grid.cell_size / sc.params.dt / 100.0
    v0 = amp * numpy.sin(numpy.arange(sc.state.x.size, dtype=numpy.float32))
    v0 = v0.reshape(sc.state.x.shape).astype(numpy.float32)
    grid, params, _ = _port(sc)
    state0 = state_from_numpy(sc.state.x, v0, CPU)
    slabs = _divisor(sc.grid.dims[0], 3)
    step_s = make_slab_step_fn(grid, params, n_slabs=slabs, device=CPU)
    step_g = make_step_fn(grid, params, device=CPU)
    ref_s = jax.jit(ref_make_slab_step_fn(sc.grid, sc.params, n_slabs=slabs,
                                          use_pallas=False))
    ss, sg, rs = state0, state0, _ref_state(state0)
    for _ in range(5):
        ss, aux = step_s(ss)
        sg, _ = step_g(sg)
        rs, raux = ref_s(rs)
        assert int(aux[3]) == int(raux[3]) == 0
    for want in (rs, sg):
        _close(ss.x, want.x, rtol=1e-4, atol=1e-6)
        _close(ss.v, want.v, rtol=1e-3, atol=1e-4)


def test_slab_step_matches_reference_global_step():
    """The reference holds its Pallas slab step (interpret mode) to its
    jnp global step; the port's slab step is held to the same step at
    the same tolerances."""
    db = ref_dam_break(n_side=8, capacity=48)
    grid, params, state = _port(db)
    step_s = make_slab_step_fn(grid, params,
                               n_slabs=_divisor(db.grid.dims[0], 3),
                               device=CPU)
    sg, _ = jax.jit(ref_make_step_fn(db.grid, db.params,
                                     use_pallas=False))(db.state)
    ss, aux = step_s(state)
    assert int(aux[3]) == 0
    _close(ss.x, sg.x, rtol=1e-4, atol=1e-6)
    _close(ss.v, sg.v, rtol=2e-3, atol=2e-3)


def test_window_overflow_is_counted_not_silent():
    db = ref_dam_break(n_side=8, capacity=48)
    grid, params, state = _port(db)
    slabs = _divisor(db.grid.dims[0], 3)
    _, aux = make_slab_step_fn(grid, params, n_slabs=slabs, window=16,
                               device=CPU)(state)
    _, raux = jax.jit(ref_make_slab_step_fn(
        db.grid, db.params, n_slabs=slabs, window=16, use_pallas=False,
    ))(db.state)
    assert int(aux[3]) > 0
    assert int(aux[3]) == int(raux[3])


def test_cell_overflow_matches_the_reference():
    """A capacity far below the densest cell drops particles from the
    pair sums: the slab step counts them as the reference and the global
    step do, and the dropped particles move ballistically in both."""
    db = ref_dam_break(n_side=8, capacity=8)
    grid, params, state = _port(db)
    slabs = _divisor(db.grid.dims[0], 3)
    ss, aux = make_slab_step_fn(grid, params, n_slabs=slabs,
                                device=CPU)(state)
    rs, raux = jax.jit(ref_make_slab_step_fn(
        db.grid, db.params, n_slabs=slabs, use_pallas=False,
    ))(db.state)
    sg, gaux = make_step_fn(grid, params, device=CPU)(state)
    assert int(aux[2]) > 0
    assert int(aux[2]) == int(raux[2]) == int(gaux[2])
    assert torch.equal(ss.x, sg.x) and torch.equal(aux[0], gaux[0])
    _close(ss.x, rs.x, rtol=1e-5, atol=1e-7)


def test_n_fixed_boundary_particles_do_not_move():
    sc = ref_hydrostatic_tank(n_side=6)
    grid, params, state = _port(sc)
    slabs = _divisor(sc.grid.dims[0], 3)
    out, aux = make_slab_step_fn(grid, params, n_slabs=slabs,
                                 n_fixed=sc.n_fixed, device=CPU)(state)
    assert torch.equal(out.x[: sc.n_fixed], state.x[: sc.n_fixed])
    assert float(out.v[: sc.n_fixed].abs().max()) == 0.0
    ref, _ = jax.jit(ref_make_slab_step_fn(
        sc.grid, sc.params, n_slabs=slabs, use_pallas=False,
        n_fixed=sc.n_fixed,
    ))(sc.state)
    _close(out.x, ref.x, rtol=1e-5, atol=1e-7)


def test_bad_slab_count_raises():
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, _ = _port(db)
    with pytest.raises(ValueError, match="multiple of n_slabs"):
        make_slab_step_fn(grid, params, n_slabs=db.grid.dims[0] + 1,
                          device=CPU)


def test_density_renorm_parity_with_global_step():
    sc = ref_hydrostatic_tank(n_side=6)
    grid, params, state = _port(sc)
    slabs = _divisor(sc.grid.dims[0], 3)
    kw = dict(n_fixed=sc.n_fixed, density_renorm=True)
    ss, (rs, _, _, w) = make_slab_step_fn(grid, params, n_slabs=slabs,
                                          device=CPU, **kw)(state)
    rg_state, (rg, _, _) = jax.jit(ref_make_step_fn(
        sc.grid, sc.params, use_pallas=False, **kw))(sc.state)
    sg, (pg, _, _) = make_step_fn(grid, params, device=CPU, **kw)(state)
    assert int(w) == 0
    assert float(rs.min()) >= params.rho0  # the floor holds
    for want_x, want_r in ((rg_state.x, rg), (sg.x, pg)):
        _close(rs, want_r, rtol=2e-5, atol=1e-2)
        _close(ss.x, want_x, rtol=1e-5, atol=1e-7)


def test_continuity_slab_step_matches_global_continuity():
    """Continuity: the carried density rides the sorted features as a
    7th row and one fused momentum + continuity pass runs per slab; 3
    steps in lockstep with the reference's slab step and both global
    steps."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    st0 = ref_init_density(db.state, db.grid, db.params)
    grid, params, _ = _port(db)
    state0 = state_from_numpy(st0.x, st0.v, CPU, rho=st0.rho)
    kw = dict(density_mode="continuity")
    step_s = make_slab_step_fn(grid, params, n_slabs=3, device=CPU, **kw)
    step_g = make_step_fn(grid, params, device=CPU, **kw)
    ref_s = jax.jit(ref_make_slab_step_fn(db.grid, db.params, n_slabs=3,
                                          use_pallas=False, **kw))
    ref_g = jax.jit(ref_make_step_fn(db.grid, db.params, use_pallas=False,
                                     **kw))
    ss, sg, rs, rg = state0, state0, st0, st0
    for _ in range(3):
        ss, (r_s, _, _, w) = step_s(ss)
        sg, (r_g, _, _) = step_g(sg)
        rs, (r_rs, _, _, rw) = ref_s(rs)
        rg, (r_rg, _, _) = ref_g(rg)
        assert int(w) == int(rw) == 0
    for want, want_r in ((rs, r_rs), (rg, r_rg), (sg, r_g)):
        _close(ss.x, want.x, rtol=1e-5, atol=1e-6)
        _close(ss.v, want.v, rtol=5e-4, atol=5e-4)
        _close(r_s, want_r, rtol=5e-4)
    assert torch.equal(ss.x, sg.x) and torch.equal(ss.rho, sg.rho)


def test_slab_init_density_matches_init_density():
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, state = _port(db)
    st_s = slab_init_density(state, grid, params, 3, device=CPU)
    _close(st_s.rho, ref_init_density(db.state, db.grid, db.params).rho,
           rtol=2e-5, atol=1e-2)
    _close(st_s.rho,
           ref_slab_init_density(db.state, db.grid, db.params, 3,
                                 use_pallas=False).rho,
           rtol=2e-5, atol=1e-2)
    _close(st_s.rho, init_density(state, grid, params, device=CPU).rho,
           rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("capacity", ["auto", 24])
def test_spill_slab_matches_single_tier(density_mode, capacity):
    """The two-tier spill slab step (the plain spill ops, ``spill=True``)
    against the reference's jnp single-tier slab step with capacity for
    the worst cell (K = 64), as the reference holds its Pallas spill slab
    step, over 2 steps: at the reference's capacity ("auto" clamped to
    24-64, the spill tier empty) and at K = 24, where it is occupied."""
    db = ref_dam_break(n_side=10, capacity="auto", capacity_headroom=1.15)
    cap = min(max(db.grid.capacity, 24), 64) if capacity == "auto" else 24
    grid_big = db.grid._replace(capacity=64)
    continuity = density_mode == "continuity"
    st0 = (ref_init_density(db.state, grid_big, db.params) if continuity
           else db.state)
    grid, params, state = _port(db._replace(state=st0),
                                db.grid._replace(capacity=cap))
    counts = numpy.bincount(_cell_ids(state.x, grid), minlength=grid.n_cells)
    assert (counts > cap).any() == (capacity == 24)
    step_sp = make_slab_step_fn(grid, params, n_slabs=3, spill=True,
                                density_mode=density_mode, device=CPU)
    assert step_sp.resolved["spill"] and not step_sp.resolved["use_kernels"]
    step_ref = jax.jit(ref_make_slab_step_fn(
        grid_big, db.params, n_slabs=3, density_mode=density_mode,
        use_pallas=False))
    sa, sb = st0, state
    for _ in range(2):
        sa, (ra, _pa, _oa, _wa) = step_ref(sa)
        sb, (rb, _pb, ob, wb) = step_sp(sb)
        assert int(ob) == int(wb) == 0
    _close(sb.x, sa.x, rtol=1e-5, atol=1e-6)
    _close(rb, ra, rtol=5e-4)


def _cell_ids(x, grid):
    from tpgsd_torch.sph.cells import cell_id

    return cell_id(x, grid).numpy()


def test_continuity_slab_requires_rho():
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, state = _port(db)
    step_s = make_slab_step_fn(grid, params, n_slabs=3,
                               density_mode="continuity", device=CPU)
    with pytest.raises(ValueError, match="slab_init_density"):
        step_s(state)


def test_continuity_renorm_rejected():
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, _ = _port(db)
    with pytest.raises(ValueError, match="delta_sph"):
        make_slab_step_fn(grid, params, n_slabs=3, density_mode="continuity",
                          density_renorm=True, device=CPU)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_slab_step_lays_out_no_global_cell_grid(spill):
    """No tensor of the slab step has a cell axis of the global grid with
    slots: its dense tensors are one slab's extended grid (the global
    step's ``[C, K]`` maps are what the slab step exists to avoid)."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, params, state = _port(db, db.grid._replace(capacity=24))
    c, k = grid.n_cells, grid.capacity
    step_s = make_slab_step_fn(grid, params, n_slabs=3, spill=spill,
                               device=CPU)
    with _Shapes() as rec:
        step_s(state)
    nxl = grid.dims[0] // 3
    c_ext = (nxl + 4) * grid.dims[1] * grid.dims[2]
    dense = [s for s in rec.shapes if any(d in (c, c + 1) for d in s)
             and int(numpy.prod(s)) >= c * k]
    assert dense == [], dense
    assert any(c_ext in s and k in s for s in rec.shapes)
    with _Shapes() as rec_g:
        make_step_fn(grid, params, spill=spill, device=CPU)(state)
    assert any(s[:2] in ((c, k), (c + 1, k)) for s in rec_g.shapes)


def test_slab_tiers_are_slices_of_the_global_layout():
    """``slab_tiers`` (the slab step's own layout, which the card check
    holds the kernels on) gives each slab's extended range of the global
    two-tier layout: the core and halo planes as the global step lays
    them out, the planes past the domain empty."""
    db = ref_dam_break(n_side=10, capacity=CAP)
    grid, _params, state = _port(db, db.grid._replace(capacity=24))
    k, n_slabs = grid.capacity, 3
    x_ext = grid.dims[0] // n_slabs
    nynz = grid.dims[1] * grid.dims[2]
    cells, sp = build_cells_spill(state.x, grid, k)
    xv = torch.cat([state.x, state.v], dim=-1)
    glob = [(scatter_to_cells_soa(xv, cells, grid), cells.mask),
            (scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k),
             sp.mask)]
    assert bool(sp.mask.any())
    seen = []
    for s, ext, tiers in slab_tiers(state, grid, n_slabs, range(n_slabs)):
        seen.append(s)
        assert ext.dims == (x_ext + 4,) + tuple(grid.dims[1:])
        for (soa, live), (g_soa, g_live) in zip(tiers, glob):
            for plane in range(x_ext + 4):
                gx = s * x_ext - 2 + plane
                got = slice(plane * nynz, (plane + 1) * nynz)
                if 0 <= gx < grid.dims[0]:
                    want = slice(gx * nynz, (gx + 1) * nynz)
                    assert torch.equal(live[got], g_live[want])
                    assert torch.equal(soa[:, got], g_soa[:, want])
                else:
                    assert not bool(live[got].any())
    assert seen == list(range(n_slabs))
