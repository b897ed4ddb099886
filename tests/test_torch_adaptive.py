"""The port's CFL-adaptive step and rollout (``make_adaptive_step_fn``,
``run_adaptive``) on the CPU, mirroring tests/test_sph.py's adaptive
tests, and against the JAX package's jitted jnp path on the same seeded
input.

Tolerances: the adaptive step at ``dt == params.dt`` is bit-identical to
the fixed step (one body serves both); against JAX, ``dt_next``, ``t``
and the controller's ``a2max`` rtol 1e-5, positions rtol 1e-5, atol 1e-6
(the ROADMAP North-star), the carried density rtol 1e-4, atol 1e-2 (as
tests/test_torch_step.py holds it).
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_adaptive_step_fn as ref_make_adaptive_step_fn
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd.sph import run_adaptive as ref_run_adaptive
from tpgsd_torch.sph import (
    dam_break,
    hydrostatic_tank,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
    run_adaptive,
    still_box,
)
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)

MODES = ("summation", "continuity")


def _case(n_side=6, layout="single", density_mode="summation"):
    """``(grid, params, state)`` of the dam break on the CPU: the single
    tier at the default capacity, or the two-tier layout at K = 24 (its
    spill tier occupied)."""
    db = dam_break(n_side=n_side, device="cpu")
    grid = db.grid._replace(capacity=24) if layout == "spill" else db.grid
    state = db.state
    if density_mode == "continuity":
        state = init_density(state, grid, db.params, device="cpu")
    return grid, db.params, state


def _adaptive(grid, params, layout="single", **kw):
    return make_adaptive_step_fn(grid, params, spill=layout == "spill",
                                 device="cpu", **kw)


def _fixed(grid, params, layout="single", **kw):
    return make_step_fn(grid, params, spill=layout == "spill", device="cpu",
                        **kw)


@pytest.mark.parametrize("density_mode", MODES)
@pytest.mark.parametrize("layout", ["single", "spill"])
def test_adaptive_step_matches_fixed_at_same_dt(layout, density_mode):
    """Three steps at ``dt == params.dt`` (a 0-d float32 tensor) give the
    fixed step's positions, velocities and densities bit for bit."""
    grid, params, state = _case(layout=layout, density_mode=density_mode)
    step_f = _fixed(grid, params, layout, density_mode=density_mode)
    step_a = _adaptive(grid, params, layout, density_mode=density_mode)
    assert step_a.resolved == step_f.resolved
    assert step_a.resolved["spill"] == (layout == "spill")
    dt = torch.tensor(params.dt, dtype=torch.float32)
    s_f = s_a = state
    for _ in range(3):
        s_f, aux_f = step_f(s_f)
        s_a, aux_a, dt_next = step_a(s_a, dt)
        assert dt_next.shape == () and dt_next.dtype == torch.float32
    assert torch.equal(s_a.x, s_f.x)
    assert torch.equal(s_a.v, s_f.v)
    assert torch.equal(aux_a[0], aux_f[0])
    assert torch.equal(aux_a[1], aux_f[1])
    if density_mode == "continuity":
        assert torch.equal(s_a.rho, s_f.rho)


def test_adaptive_dt_is_an_operand():
    """Two dts through one step give two trajectories, and the smaller
    dt moves the particles less."""
    grid, params, state = _case()
    step = _adaptive(grid, params)
    s1, _, _ = step(state, torch.tensor(params.dt))
    s2, _, _ = step(state, torch.tensor(0.25 * params.dt))
    d1 = float((s1.x - state.x).abs().max())
    d2 = float((s2.x - state.x).abs().max())
    assert 0.0 < d2 < d1


def test_adaptive_controller_bounds_and_dt_min_floor():
    """``dt_next`` stays in ``(0, params.dt]`` on the dam break, the
    quiescent still box gets no order-of-magnitude cut, and ``dt_min``
    floors the controller."""
    grid, params, s = _case(n_side=8)
    step = _adaptive(grid, params, cfl=0.25)
    dt = torch.tensor(params.dt, dtype=torch.float32)
    for _ in range(5):
        s, _aux, dt = step(s, dt)
        assert 0.0 < float(dt) <= float(numpy.float32(params.dt))

    sb = still_box(n_side=6, device="cpu")
    step_q = make_adaptive_step_fn(sb.grid, sb.params, cfl=0.25, device="cpu")
    _s, _aux, dt_q = step_q(sb.state, torch.tensor(sb.params.dt))
    assert float(dt_q) > 0.1 * sb.params.dt

    step_floor = _adaptive(grid, params, cfl=1e-6, dt_min=0.5 * params.dt)
    _s, _aux, dt_f = step_floor(s, dt)
    assert float(dt_f) == pytest.approx(0.5 * params.dt)


def test_run_adaptive_matches_eager_replay():
    """``run_adaptive`` equals stepping by hand: the same state bit for
    bit, the same ``dt_next``, and ``t`` is the float32 running sum of
    the dts taken, in order."""
    grid, params, state = _case()
    step = _adaptive(grid, params, cfl=0.3)
    s_run, dt_run, t_run = run_adaptive(step, state, params.dt, 5)
    assert dt_run.dtype == torch.float32 and t_run.dtype == torch.float32

    s, dt = state, torch.tensor(params.dt, dtype=torch.float32)
    t = numpy.float32(0.0)
    for _ in range(5):
        t = numpy.float32(t + dt.numpy())
        s, _aux, dt = step(s, dt)
    assert torch.isfinite(s_run.x).all()
    assert torch.equal(s_run.x, s.x) and torch.equal(s_run.v, s.v)
    assert float(dt_run) == float(dt)
    assert t_run.numpy() == t
    # a tensor dt0 (a dt_next kept from an earlier rollout) is taken as is
    s_half, dt_half, t_half = run_adaptive(step, state, params.dt, 2)
    s_rest, dt_rest, t_rest = run_adaptive(step, s_half, dt_half, 3)
    assert torch.equal(s_rest.x, s_run.x) and torch.equal(dt_rest, dt_run)


def test_adaptive_with_fixed_boundary_particles():
    """``n_fixed`` composes: the boundary slots never move under the
    adaptive step, and the controller sees the mobile particles only."""
    sc = hydrostatic_tank(n_side=6, device="cpu")
    step = make_adaptive_step_fn(sc.grid, sc.params, n_fixed=sc.n_fixed,
                                 cfl=0.25, device="cpu")
    s = sc.state
    dt = torch.tensor(sc.params.dt, dtype=torch.float32)
    for _ in range(3):
        s, _aux, dt = step(s, dt)
    assert torch.equal(s.x[: sc.n_fixed], sc.state.x[: sc.n_fixed])
    assert float(dt) > 0.0
    base = make_step_fn(sc.grid, sc.params, n_fixed=sc.n_fixed, device="cpu",
                        _traced_dt=True)
    new, _aux, a2max = base(sc.state, torch.tensor(sc.params.dt))
    # the mobile particles' largest |a|^2, from their velocity change
    # (the tank starts at rest, and no particle reaches a wall in a step)
    acc = (new.v - sc.state.v)[sc.n_fixed:] / numpy.float32(sc.params.dt)
    want = float(torch.amax(torch.sum(acc * acc, dim=-1)))
    assert float(a2max) == pytest.approx(want, rel=1e-3)


def _moving_reference(n_side=6, seed=0, scale=0.1):
    """The JAX dam break with seeded N(0, scale^2) velocities."""
    db = ref_dam_break(n_side=n_side)
    x0 = numpy.asarray(db.state.x)
    rng = numpy.random.default_rng(seed)
    v0 = (scale * rng.standard_normal(x0.shape)).astype(numpy.float32)
    return db, x0, v0


@pytest.mark.parametrize("density_mode", MODES)
def test_run_adaptive_matches_jax(density_mode):
    """Five adaptive steps of both packages from the same moving dam break
    (JAX: ``run_adaptive`` under jit on the jnp path; the port: the plain
    passes): ``dt_next``, ``t``, positions and the carried density."""
    db, x0, v0 = _moving_reference()
    state_r = RefState(x=x0, v=v0)
    if density_mode == "continuity":
        state_r = ref_init_density(state_r, db.grid, db.params)
    step_r = ref_make_adaptive_step_fn(db.grid, db.params, use_pallas=False,
                                       density_mode=density_mode)
    s_r, dt_r, t_r = jax.jit(
        lambda s: ref_run_adaptive(step_r, s, db.params.dt, 5)
    )(state_r)

    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    state = state_from_numpy(
        x0, v0, "cpu",
        rho=None if state_r.rho is None else numpy.asarray(state_r.rho),
    )
    step = make_adaptive_step_fn(grid, params, density_mode=density_mode,
                                 device="cpu")
    s, dt, t = run_adaptive(step, state, params.dt, 5)

    numpy.testing.assert_allclose(float(dt), float(dt_r), rtol=1e-5)
    numpy.testing.assert_allclose(float(t), float(t_r), rtol=1e-5)
    assert float(dt) < params.dt  # the controller acted
    numpy.testing.assert_allclose(s.x.numpy(), numpy.asarray(s_r.x),
                                  rtol=1e-5, atol=1e-6)
    if density_mode == "continuity":
        numpy.testing.assert_allclose(s.rho.numpy(), numpy.asarray(s_r.rho),
                                      rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("density_mode", MODES)
def test_controller_input_matches_jax(density_mode):
    """The traced-dt step's ``a2max`` against the JAX step's, at a quarter
    of ``params.dt``, from the same moving dam break."""
    db, x0, v0 = _moving_reference(seed=1)
    state_r = RefState(x=x0, v=v0)
    if density_mode == "continuity":
        state_r = ref_init_density(state_r, db.grid, db.params)
    base_r = jax.jit(ref_make_step_fn(db.grid, db.params, use_pallas=False,
                                      density_mode=density_mode,
                                      _traced_dt=True))
    dt = 0.25 * db.params.dt
    s_r, _aux, a2_r = base_r(state_r, jnp.float32(dt))

    base = make_step_fn(grid_from_reference(db.grid),
                        params_from_reference(db.params),
                        density_mode=density_mode, device="cpu",
                        _traced_dt=True)
    state = state_from_numpy(
        x0, v0, "cpu",
        rho=None if state_r.rho is None else numpy.asarray(state_r.rho),
    )
    s, _aux, a2 = base(state, torch.tensor(dt, dtype=torch.float32))
    assert a2.shape == ()
    numpy.testing.assert_allclose(float(a2), float(a2_r), rtol=1e-5)
    numpy.testing.assert_allclose(s.x.numpy(), numpy.asarray(s_r.x),
                                  rtol=1e-5, atol=1e-6)


def test_adaptive_forwards_the_step_options():
    """``**kwargs`` reach ``make_step_fn``: the options, periodic boxes
    and the layouts build and step, and ``resolved`` is the step's."""
    grid, params, state = _case(n_side=5)
    step = _adaptive(grid, params, "spill", xsph=0.5, surface_tension=0.05,
                     density_renorm=True)
    assert step.resolved == {"use_kernels": False, "spill": True,
                             "density_mode": "summation"}
    s, (rho, p, ov), dt = step(state, torch.tensor(params.dt))
    assert torch.isfinite(s.x).all() and int(ov) == 0 and float(dt) > 0
    sb = still_box(n_side=6, device="cpu")
    step_p = make_adaptive_step_fn(sb.grid, sb.params, periodic=True,
                                   device="cpu")
    s, _aux, dt = step_p(sb.state, torch.tensor(sb.params.dt))
    assert torch.isfinite(s.x).all() and float(dt) > 0
    with pytest.raises(NotImplementedError, match="item 9"):
        make_adaptive_step_fn(grid, params, sharding=2, device="cpu")


def test_adaptive_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device works")
    grid, params, _ = _case(n_side=4)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        make_adaptive_step_fn(grid, params)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        dam_break(n_side=4, on_device=True)
