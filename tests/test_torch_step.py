"""The torch port's SPH step against the JAX package: the spill slice with
its async GSD dump (JAX spill step in Pallas interpret mode), the
single-tier plain path (JAX jnp path), continuity-density mode on both
layouts, the auto policy, the ported options (their parity is in
tests/test_torch_options.py) and the option that is not ported yet.

Tolerances: positions rtol 1e-5, atol 1e-6; density rtol 1e-5, atol 1e-6
and velocity rtol 1e-4, atol 1e-5 on values scaled by their max (as
tests/test_spill.py holds the Pallas step to the jnp step); the carried
density of continuity mode rtol 1e-4, atol 1e-2 (as
tests/test_pallas_ops.py holds it).
"""

import inspect

import numpy
import pytest
import torch

import jax

import tpgsd_torch.hoomd
from tpgsd.sph import SPHState as RefState
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import density_and_pressure as ref_density_and_pressure
from tpgsd.sph import init_density as ref_init_density
from tpgsd.sph import make_step_fn as ref_make_step_fn
from tpgsd_torch.entry import entry
from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.parallel import (
    ShardedFrameWriter,
    ShardedTrajectoryReader,
    SingleComm,
    read_sharded_chunk,
)
from tpgsd_torch.sph import (
    dam_break,
    dam_break_2d,
    density_and_pressure,
    hydrostatic_tank,
    init_density,
    make_step_fn,
    ops,
    still_box,
    still_box_2d,
    taylor_green,
)
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
    step = make_step_fn(grid, params, spill=True, device="cpu")
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
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
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
        grid_from_reference(db.grid), params_from_reference(db.params),
        device="cpu", **kw
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
    step = make_step_fn(
        grid, params, use_kernels=use_kernels, spill=spill, device="cpu"
    )
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
        (128, "auto", "auto", (True, False)),
        (72, "auto", "auto", (True, False)),
        (256, True, False, (True, False)),
        (32, "auto", False, (True, False)),
        (32, True, False, (True, False)),
    ],
)
def test_policy_on_cuda(capacity, use_kernels, spill, want):
    grid = _small()[0]._replace(capacity=capacity)
    assert resolve_policy("cuda", grid, use_kernels, spill) == want


@pytest.mark.parametrize(
    "capacity, use_kernels, spill, limit",
    [(1032, "auto", "auto", 1024), (1032, True, False, 1024),
     (128, "auto", True, 64), (72, True, True, 64)],
)
def test_policy_on_cuda_raises_where_the_kernels_do_not_apply(
    capacity, use_kernels, spill, limit
):
    """No quiet plain path on the card: "auto" raises like True does, with
    ``ValueError`` as the reference does for ``spill=True`` at a capacity
    its two-tier kernels do not take, and the message names the limit."""
    grid = _small()[0]._replace(capacity=capacity)
    with pytest.raises(
        ValueError, match="capacity <= %d; got %d" % (limit, capacity)
    ):
        resolve_policy("cuda", grid, use_kernels, spill)


def test_kernels_on_cpu_raise():
    grid, params = _small()
    with pytest.raises(ValueError, match="CUDA"):
        make_step_fn(grid, params, use_kernels=True, spill=True, device="cpu")


@pytest.mark.parametrize("kw", [{"sharding": 4}], ids=["sharding"])
def test_unported_options_raise(kw):
    grid, params = _small()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        make_step_fn(grid, params, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [{"periodic": True, "xsph": 0.5}, {"xsph": 0.5}, {"surface_tension": 0.1}],
    ids=["periodic_xsph", "xsph", "surface_tension"],
)
def test_ported_options_build_and_step_on_cpu(kw):
    """The options that raised before they were ported build a step that
    runs on the CPU, keeps the state finite and in the box, and moves it
    otherwise than the step without them."""
    db = ref_dam_break(n_side=6, capacity=64)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    x0, v0 = _moving_state(db)
    state = state_from_numpy(x0, v0, "cpu")
    step = make_step_fn(grid, params, device="cpu", **kw)
    base = make_step_fn(grid, params, device="cpu",
                        periodic=kw.get("periodic", False))
    assert step.resolved == base.resolved == {
        "use_kernels": False, "spill": False, "density_mode": "summation"
    }
    new, (rho, p, ov) = step(state)
    plain, _ = base(state)
    assert int(ov) == 0 and new.x.shape == state.x.shape
    assert bool(torch.isfinite(new.x).all() and torch.isfinite(new.v).all())
    assert not torch.equal(new.x, plain.x)
    hi = numpy.asarray(db.box, numpy.float32)
    assert bool((new.x >= 0).all()) and bool((new.x <= torch.from_numpy(hi)).all())


@pytest.mark.parametrize("kw", [{"xsph": -0.5}, {"surface_tension": -1.0}],
                         ids=["xsph", "surface_tension"])
def test_negative_option_strengths_raise(kw):
    grid, params = _small()
    with pytest.raises(ValueError, match=">= 0"):
        make_step_fn(grid, params, device="cpu", **kw)


def test_step_rejects_a_state_on_another_device():
    grid, params = _small()
    step = make_step_fn(grid, params, device="cpu")
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        step(state_from_numpy(numpy.zeros((4, 3)), numpy.zeros((4, 3)), "cpu")
             ._replace(x=x, v=x))


# --------------------------------------------------------------------------
# continuity-density mode
# --------------------------------------------------------------------------


def _continuity_case(capacity=48):
    """``dam_break(n_side=6)`` with seeded velocities, in both packages;
    32 of its 384 particles overflow a 48-slot cell, so the dropped
    particles' carried density is exercised too."""
    db = ref_dam_break(n_side=6, capacity=capacity)
    x0, v0 = _moving_state(db)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    return db, x0, v0, grid, params


@pytest.mark.parametrize("density_renorm", [False, True])
def test_density_and_pressure_matches_reference(density_renorm):
    db, x0, _, grid, params = _continuity_case()
    rho_r, p_r = ref_density_and_pressure(
        x0, db.grid, db.params, density_renorm=density_renorm
    )
    rho, p = density_and_pressure(
        torch.from_numpy(x0), grid, params, density_renorm=density_renorm,
        device="cpu",
    )
    numpy.testing.assert_allclose(rho.numpy(), numpy.asarray(rho_r), rtol=1e-5)
    _scaled_close(p.numpy(), p_r, 1e-4, 1e-5)


def test_init_density_matches_reference():
    db, x0, v0, grid, params = _continuity_case()
    want = ref_init_density(RefState(x=x0, v=v0), db.grid, db.params)
    got = init_density(state_from_numpy(x0, v0, "cpu"), grid, params, device="cpu")
    assert got.rho.shape == (x0.shape[0],) and got.rho.dtype == torch.float32
    numpy.testing.assert_allclose(got.rho.numpy(), numpy.asarray(want.rho), rtol=1e-5)
    assert got.x is not None and torch.equal(got.v, torch.from_numpy(v0))


@pytest.mark.parametrize("rho", [1000.0, "per_particle"])
def test_init_density_takes_an_explicit_seed(rho):
    _, x0, v0, grid, params = _continuity_case()
    if rho == "per_particle":
        rho = numpy.linspace(900.0, 1100.0, x0.shape[0]).astype(numpy.float32)
    got = init_density(
        state_from_numpy(x0, v0, "cpu"), grid, params, rho=rho, device="cpu"
    )
    want = numpy.broadcast_to(numpy.float32(rho), (x0.shape[0],))
    numpy.testing.assert_array_equal(got.rho.numpy(), want)


@pytest.mark.parametrize(
    "spill, delta_sph, n_fixed",
    [(False, 0.1, 0), (True, 0.1, 0), (False, 0.0, 0), (True, 0.0, 0),
     (True, 0.1, 50)],
    ids=["single_tier", "spill", "single_tier_delta0", "spill_delta0",
         "spill_n_fixed"],
)
def test_continuity_step_matches_jnp_path(spill, delta_sph, n_fixed):
    """Two plain continuity steps (single tier at K = 48, and the two-tier
    layout at K = 24 + 24, slot-identical to it) against the jitted JAX
    step on the jnp path."""
    db, x0, v0, grid, params = _continuity_case()
    step_ref = jax.jit(ref_make_step_fn(
        db.grid, db.params, use_pallas=False, density_mode="continuity",
        delta_sph=delta_sph, n_fixed=n_fixed,
    ))
    step = make_step_fn(
        grid._replace(capacity=24) if spill else grid, params, spill=spill,
        density_mode="continuity", delta_sph=delta_sph, n_fixed=n_fixed,
        device="cpu",
    )
    assert step.resolved == {
        "use_kernels": False, "spill": spill, "density_mode": "continuity"
    }
    state_r = ref_init_density(RefState(x=x0, v=v0), db.grid, db.params)
    state = state_from_numpy(x0, v0, "cpu", rho=numpy.asarray(state_r.rho))
    for _ in range(2):
        state_r, (rho_r, p_r, ov_r) = step_ref(state_r)
        state, (rho, p, ov) = step(state)
        assert int(ov) == int(ov_r)
    numpy.testing.assert_allclose(
        state.x.numpy(), numpy.asarray(state_r.x), rtol=1e-5, atol=1e-6
    )
    numpy.testing.assert_allclose(
        state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-4, atol=1e-2
    )
    assert torch.equal(rho, state.rho)
    _scaled_close(p.numpy(), p_r, 1e-4, 1e-5)
    if n_fixed:
        numpy.testing.assert_array_equal(state.x.numpy()[:n_fixed], x0[:n_fixed])
        assert not state.v.numpy()[:n_fixed].any()
        # fixed particles' density still evolves
        assert (state.rho.numpy()[:n_fixed] != numpy.asarray(
            ref_init_density(RefState(x=x0, v=v0), db.grid, db.params).rho
        )[:n_fixed]).any()


def test_continuity_run_past_64_slots_matches_jnp_path():
    """Twenty plain continuity steps on the single tier at K = 72 (the
    layout of the momentum tile kernels past 64 slots), delta-SPH 0.1,
    against the jitted JAX step on the jnp path: positions and the
    carried density are held at step 10 and after the last step, so a
    drift that grows over a run shows."""
    db, x0, v0, grid, params = _continuity_case(capacity=72)
    step_ref = jax.jit(ref_make_step_fn(
        db.grid, db.params, use_pallas=False, density_mode="continuity",
        delta_sph=0.1,
    ))
    step = make_step_fn(grid, params, spill=False, density_mode="continuity",
                        delta_sph=0.1, device="cpu")
    state_r = ref_init_density(RefState(x=x0, v=v0), db.grid, db.params)
    state = state_from_numpy(x0, v0, "cpu", rho=numpy.asarray(state_r.rho))
    for i in range(1, 21):
        state_r, (_, _, ov_r) = step_ref(state_r)
        state, (_, _, ov) = step(state)
        assert int(ov) == int(ov_r)
        if i in (10, 20):
            numpy.testing.assert_allclose(
                state.x.numpy(), numpy.asarray(state_r.x), rtol=1e-5,
                atol=1e-6, err_msg="positions at step %d" % i)
            numpy.testing.assert_allclose(
                state.rho.numpy(), numpy.asarray(state_r.rho), rtol=1e-4,
                atol=1e-2, err_msg="carried density at step %d" % i)
    # the run moved the particles and the density
    assert float(numpy.abs(state.x.numpy() - x0).max()) > 1e-4
    assert float(numpy.abs(state.rho.numpy() - ref_init_density(
        RefState(x=x0, v=v0), db.grid, db.params).rho).max()) > 1.0


def test_first_continuity_step_moves_like_the_summation_step():
    """Seeded with the summation density, the first continuity step sees
    the same density and pressure as the summation step, so positions
    and velocities agree (tests/test_sph.py holds the JAX step to this)."""
    db = ref_dam_break(n_side=10, capacity=48)
    x0, v0 = _moving_state(db)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    state = state_from_numpy(x0, v0, "cpu")
    summed, (rho_s, _, ov_s) = make_step_fn(grid, params, device="cpu")(state)
    seeded = init_density(state, grid, params, device="cpu")
    numpy.testing.assert_allclose(seeded.rho.numpy(), rho_s.numpy(), rtol=1e-6)
    carried, (_, _, ov_c) = make_step_fn(
        grid, params, density_mode="continuity", device="cpu"
    )(seeded)
    assert int(ov_s) == int(ov_c) == 0
    numpy.testing.assert_allclose(
        carried.x.numpy(), summed.x.numpy(), rtol=1e-5, atol=1e-6
    )
    _scaled_close(carried.v.numpy(), summed.v.numpy(), 1e-4, 1e-5)
    assert summed.rho is None and carried.rho is not None


@pytest.mark.parametrize("spill", [False, True])
def test_continuity_without_a_seed_raises(spill):
    grid, params = _small()
    step = make_step_fn(
        grid, params, density_mode="continuity", spill=spill, device="cpu"
    )
    state = state_from_numpy(numpy.zeros((4, 3)), numpy.zeros((4, 3)), "cpu")
    with pytest.raises(ValueError, match="init_density"):
        step(state)


def test_continuity_excludes_density_renorm():
    grid, params = _small()
    with pytest.raises(ValueError, match="density_renorm"):
        make_step_fn(grid, params, density_mode="continuity",
                     density_renorm=True, device="cpu")
    with pytest.raises(ValueError, match="unknown density_mode"):
        make_step_fn(grid, params, density_mode="euler", device="cpu")


@pytest.mark.parametrize("spill", ["auto", False])
def test_continuity_on_cuda_resolves_like_summation(spill):
    """One policy for both density modes: on the card "auto" means the
    kernels, on the spill layout unless the caller asks for the single
    tier."""
    grid = _small()[0]
    want = (True, spill == "auto")
    assert resolve_policy("cuda", grid, "auto", spill) == want
    for mode in ("summation", "continuity"):
        assert ops.accel_drho_supported(grid) and ops.supported(grid), mode


def test_entry_continuity_on_cpu_carries_the_density():
    step, (state,) = entry(n_side=6, device="cpu", density_mode="continuity")
    assert step.resolved == {
        "use_kernels": False, "spill": False, "density_mode": "continuity"
    }
    assert state.rho is not None and state.rho.shape == (state.x.shape[0],)
    new, (rho, p, ov) = step(state)
    assert int(ov) == 0 and torch.equal(new.rho, rho)
    assert bool(torch.isfinite(new.x).all()) and bool(torch.isfinite(rho).all())


@pytest.mark.parametrize(
    "fn",
    [make_step_fn, dam_break, init_density, density_and_pressure, entry,
     hydrostatic_tank, still_box, dam_break_2d, still_box_2d, taylor_green,
     read_sharded_chunk, ShardedTrajectoryReader],
    ids=lambda fn: fn.__name__,
)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device works")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        dam_break(n_side=4)
    grid, params = _small()
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        make_step_fn(grid, params)
