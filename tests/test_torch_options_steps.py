"""The port's plain step with the XSPH and Akinci surface-tension options
against the jitted JAX jnp step on the CPU (single tier, and the two-tier
layout against the reference's single tier of twice the capacity, which
is slot-identical), in both density modes, with ``periodic`` and
``n_fixed``; and the options at 0 as today's step, bit for bit.  The
passes themselves are held in tests/test_torch_options.py.

Tolerances: positions rtol 1e-5, atol 1e-6; velocity rtol 1e-4, atol 1e-5
scaled by its max; summation density rtol 1e-5, atol 1e-6 scaled; the
carried density rtol 1e-4, atol 1e-2 (as tests/test_torch_step.py holds
the step).
"""

import numpy
import pytest
import torch

import jax

from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd_torch.sph import dam_break, init_density, make_step_fn
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)

GAMMA = 0.05  # the surface-tension strength of tests/test_spill.py
XSPH = 0.5


def _scaled_close(got, want, rtol=1e-4, atol=1e-5, err_msg=""):
    """``got`` against ``want``, scaled by max|want|."""
    got, want = numpy.asarray(got), numpy.asarray(want)
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                                  atol=atol, err_msg=err_msg)


def _moving(x0, spacing, seed, v_scale=0.5, jitter=0.05):
    rng = numpy.random.default_rng(seed)
    x = x0 + (jitter * spacing) * rng.standard_normal(x0.shape)
    v = v_scale * rng.standard_normal(x0.shape)
    return x.astype(numpy.float32), v.astype(numpy.float32)


# --------------------------------------------------------------------------
# the plain step with the options against the jitted JAX jnp step
# --------------------------------------------------------------------------


STEP_CASES = [
    # id, density mode, spill, options, steps
    ("summation-both", "summation", False,
     {"xsph": XSPH, "surface_tension": GAMMA}, 3),
    ("continuity-both", "continuity", False,
     {"xsph": XSPH, "surface_tension": GAMMA}, 3),
    ("summation-xsph-periodic-n_fixed", "summation", False,
     {"xsph": XSPH, "periodic": True, "n_fixed": 40}, 1),
    ("continuity-st-periodic-n_fixed", "continuity", False,
     {"surface_tension": GAMMA, "periodic": True, "n_fixed": 40}, 1),
    ("spill-summation-both", "summation", True,
     {"xsph": XSPH, "surface_tension": GAMMA}, 2),
    ("spill-continuity-both-periodic", "continuity", True,
     {"xsph": XSPH, "surface_tension": GAMMA, "periodic": True}, 1),
]


@pytest.mark.parametrize("mode, spill, kw, n_steps",
                         [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_step_with_options_matches_jnp_path(mode, spill, kw, n_steps):
    """The port's plain step (single tier at K = 48, or the two-tier
    layout at K = 24 + 24, slot-identical to it) against the jitted JAX
    step on the jnp path at K = 48, from a jittered dam break with
    N(0, 0.25) velocities."""
    db = ref_dam_break(n_side=7, capacity=48)
    x0, v0 = _moving(numpy.asarray(db.state.x), db.params.h / 1.3, seed=9)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    step_ref = jax.jit(ref_make_step_fn(db.grid, db.params, use_pallas=False,
                                        density_mode=mode, **kw))
    step = make_step_fn(grid._replace(capacity=24) if spill else grid, params,
                        spill=spill, density_mode=mode, device="cpu", **kw)
    assert step.resolved == {"use_kernels": False, "spill": spill,
                             "density_mode": mode}
    state_r = RefState(x=x0, v=v0)
    rho = None
    if mode == "continuity":
        state_r = ref_init_density(state_r, db.grid, db.params,
                                   periodic=kw.get("periodic", False))
        rho = numpy.asarray(state_r.rho)
    state = state_from_numpy(x0, v0, "cpu", rho=rho)
    for i in range(n_steps):
        state_r, (rho_r, _, ov_r) = step_ref(state_r)
        state, (rho, _, ov) = step(state)
        assert int(ov) == int(ov_r) == 0
        tag = "step %d" % (i + 1)
        numpy.testing.assert_allclose(state.x.numpy(), numpy.asarray(state_r.x),
                                      rtol=1e-5, atol=1e-6, err_msg=tag)
        _scaled_close(state.v.numpy(), state_r.v, err_msg=tag)
        if mode == "continuity":
            numpy.testing.assert_allclose(
                state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-4,
                atol=1e-2, err_msg=tag)
        else:
            _scaled_close(rho.numpy(), rho_r, 1e-5, 1e-6, tag)
    if kw.get("n_fixed"):
        numpy.testing.assert_array_equal(state.x.numpy()[:40], x0[:40])
        assert not state.v.numpy()[:40].any()


@pytest.mark.parametrize("mode", ["summation", "continuity"])
@pytest.mark.parametrize("spill", [False, True], ids=["single", "spill"])
def test_options_at_zero_are_the_plain_step_bit_for_bit(mode, spill):
    """``xsph=0`` and ``surface_tension=0`` run today's code path: the
    same bits as a step built without them (as tests/test_sph.py asserts
    of the reference)."""
    db = dam_break(n_side=6, capacity=48, device="cpu")
    x0, v0 = _moving(db.state.x.numpy(), db.params.h / 1.3, seed=2)
    grid = db.grid._replace(capacity=24) if spill else db.grid
    state = state_from_numpy(x0, v0, "cpu")
    if mode == "continuity":
        state = init_density(state, grid, db.params, device="cpu")
    kw = {"spill": spill, "density_mode": mode, "device": "cpu"}
    base = make_step_fn(grid, db.params, **kw)
    zero = make_step_fn(grid, db.params, xsph=0.0, surface_tension=0.0, **kw)
    s_b = s_z = state
    for _ in range(2):
        s_b, aux_b = base(s_b)
        s_z, aux_z = zero(s_z)
    for got, want in ((s_z.x, s_b.x), (s_z.v, s_b.v), (aux_z[0], aux_b[0]),
                      (aux_z[1], aux_b[1])):
        assert torch.equal(got, want)
