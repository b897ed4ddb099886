"""The torch port's SPH step against the JAX package: the spill slice with
its async GSD dump (JAX spill step in Pallas interpret mode), the
single-tier plain path (JAX jnp path), the auto policy and the options
that are not ported yet.

Tolerances: positions rtol 1e-5, atol 1e-6; density rtol 1e-5, atol 1e-6
and velocity rtol 1e-4, atol 1e-5 on values scaled by their max (as
tests/test_spill.py holds the Pallas step to the jnp step).
"""

import numpy
import pytest
import torch

import jax

import tpgsd.hoomd
from tpgsd.parallel import ShardedFrameWriter
from tpgsd.parallel.comm import SingleComm
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd_torch.entry import entry
from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.sph import make_step_fn
from tpgsd_torch.sph.convert import (
    grid_from_reference,
    params_from_reference,
    state_from_numpy,
)
from tpgsd_torch.sph.step import resolve_policy

N_STEPS = 3


def _scaled_close(got, want, rtol, atol):
    got, want = numpy.asarray(got), numpy.asarray(want)
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def spill_slice(tmp_path_factory):
    """Three spill steps of both packages from the same dam-break state
    (K = 24: the spill tier is occupied); the port dumps every step."""
    db = ref_dam_break(n_side=10, capacity=24)
    x0 = numpy.asarray(db.state.x)
    v0 = numpy.zeros_like(x0)

    step_ref = jax.jit(
        ref_make_step_fn(db.grid, db.params, use_pallas=True,
                         pallas_interpret=True, spill=True)
    )
    state_r = RefState(x=x0, v=v0)
    ref = []
    for _ in range(N_STEPS):
        state_r, (rho, _p, ov) = step_ref(state_r)
        assert int(ov) == 0
        ref.append((numpy.asarray(state_r.x), numpy.asarray(rho)))

    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    step = make_step_fn(grid, params, spill=True)
    state = state_from_numpy(x0, v0, "cpu")
    path = str(tmp_path_factory.mktemp("slice") / "slice.gsd")
    writer = ShardedFrameWriter(path, application="test", comm=SingleComm())
    overflow = []
    with AsyncDumpRunner(writer) as dump:
        for i in range(N_STEPS):
            state, (rho, p, ov) = step(state)
            overflow.append(int(ov))
            dump.submit(
                {
                    "particles/position": state.x,
                    "particles/velocity": state.v,
                    "particles/density": rho,
                    "particles/pressure": p,
                },
                step=i,
            )
        dump.flush()
    with tpgsd.hoomd.open(path, mode="r") as traj:
        frames = [
            (f.particles.position.copy(), f.particles.density.copy(),
             int(f.configuration.step))
            for f in traj
        ]
    return {"step": step, "ref": ref, "frames": frames, "overflow": overflow,
            "state": state, "stats": dump.stats}


def test_spill_slice_resolves_plain_spill_on_cpu(spill_slice):
    assert spill_slice["step"].resolved == {
        "use_kernels": False, "spill": True, "density_mode": "summation"
    }
    assert spill_slice["overflow"] == [0] * N_STEPS


@pytest.mark.parametrize("i", range(N_STEPS))
def test_spill_slice_frame_matches_reference(spill_slice, i):
    x_ref, rho_ref = spill_slice["ref"][i]
    x_got, rho_got, step = spill_slice["frames"][i]
    assert step == i
    numpy.testing.assert_allclose(x_got, x_ref, rtol=1e-5, atol=1e-6)
    _scaled_close(rho_got, rho_ref, 1e-5, 1e-6)


def test_spill_slice_last_frame_is_final_state(spill_slice):
    assert len(spill_slice["frames"]) == N_STEPS
    numpy.testing.assert_array_equal(
        spill_slice["frames"][-1][0], spill_slice["state"].x.numpy()
    )
    assert spill_slice["stats"].frames == N_STEPS


def _moving_state(db, seed=5):
    rng = numpy.random.default_rng(seed)
    x0 = numpy.asarray(db.state.x)
    v0 = (0.5 * rng.standard_normal(x0.shape)).astype(numpy.float32)
    return x0, v0


@pytest.mark.parametrize(
    "kw", [{}, {"density_renorm": True}, {"n_fixed": 50}],
    ids=["default", "density_renorm", "n_fixed"],
)
def test_single_tier_plain_matches_jnp_path(kw):
    db = ref_dam_break(n_side=10, capacity=48)
    x0, v0 = _moving_state(db)
    step_ref = jax.jit(ref_make_step_fn(db.grid, db.params, use_pallas=False, **kw))
    step = make_step_fn(
        grid_from_reference(db.grid), params_from_reference(db.params), **kw
    )
    assert step.resolved == {
        "use_kernels": False, "spill": False, "density_mode": "summation"
    }
    state_r, state = RefState(x=x0, v=v0), state_from_numpy(x0, v0, "cpu")
    for _ in range(2):
        state_r, (rho_r, _, ov_r) = step_ref(state_r)
        state, (rho, _, ov) = step(state)
        assert int(ov) == int(ov_r) == 0
        numpy.testing.assert_allclose(
            state.x.numpy(), numpy.asarray(state_r.x), rtol=1e-5, atol=1e-6
        )
        _scaled_close(state.v.numpy(), state_r.v, 1e-4, 1e-5)
        _scaled_close(rho.numpy(), rho_r, 1e-5, 1e-6)
    if "n_fixed" in kw:
        numpy.testing.assert_array_equal(state.x.numpy()[:50], x0[:50])
        assert not state.v.numpy()[:50].any()


def test_entry_on_cpu_runs_the_plain_path():
    step, (state,) = entry(n_side=6, device="cpu")
    assert step.resolved == {
        "use_kernels": False, "spill": False, "density_mode": "summation"
    }
    new, (rho, p, ov) = step(state)
    assert new.x.shape == state.x.shape and int(ov) == 0
    assert bool(torch.isfinite(new.x).all()) and bool(torch.isfinite(rho).all())


def _small():
    db = ref_dam_break(n_side=6, capacity=32)
    return grid_from_reference(db.grid), params_from_reference(db.params)


@pytest.mark.parametrize(
    "use_kernels, spill, want",
    [
        ("auto", "auto", (False, False)),
        ("auto", True, (False, True)),
        (False, True, (False, True)),
        (False, "auto", (False, False)),
    ],
)
def test_auto_policy_on_cpu(use_kernels, spill, want):
    grid, params = _small()
    step = make_step_fn(grid, params, use_kernels=use_kernels, spill=spill)
    assert (step.resolved["use_kernels"], step.resolved["spill"]) == want


@pytest.mark.parametrize(
    "capacity, use_kernels, spill, want",
    [
        (32, "auto", "auto", (True, True)),
        (64, "auto", True, (True, True)),
        (32, True, "auto", (True, True)),
        (72, False, "auto", (False, False)),
        (72, False, True, (False, True)),
        (32, False, False, (False, False)),
    ],
)
def test_policy_on_cuda(capacity, use_kernels, spill, want):
    grid = _small()[0]._replace(capacity=capacity)
    assert resolve_policy("cuda", grid, use_kernels, spill) == want


@pytest.mark.parametrize(
    "capacity, use_kernels, spill",
    [(72, "auto", "auto"), (72, True, True), (32, "auto", False),
     (32, True, False)],
)
def test_policy_on_cuda_raises_where_the_kernels_do_not_apply(
    capacity, use_kernels, spill
):
    """No quiet plain path on the card: "auto" raises like True does."""
    grid = _small()[0]._replace(capacity=capacity)
    with pytest.raises(NotImplementedError, match="queue 2, kernels 7-9"):
        resolve_policy("cuda", grid, use_kernels, spill)


def test_kernels_on_cpu_raise():
    grid, params = _small()
    with pytest.raises(ValueError, match="CUDA"):
        make_step_fn(grid, params, use_kernels=True, spill=True)


@pytest.mark.parametrize(
    "kw",
    [
        {"periodic": True},
        {"xsph": 0.5},
        {"surface_tension": 0.1},
        {"density_mode": "continuity"},
        {"sharding": 4},
    ],
    ids=["periodic", "xsph", "surface_tension", "continuity", "sharding"],
)
def test_unported_options_raise(kw):
    grid, params = _small()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_step_fn(grid, params, **kw)


def test_step_rejects_a_state_on_another_device():
    grid, params = _small()
    step = make_step_fn(grid, params, device="cpu")
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        step(state_from_numpy(numpy.zeros((4, 3)), numpy.zeros((4, 3)), "cpu")
             ._replace(x=x, v=x))
