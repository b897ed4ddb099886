"""Spill pair passes of the torch port: the plain versions against the JAX
package's Pallas entry points (run in interpret mode, as the JAX tests
run them on the CPU), and the dispatch rule of the kernel wrappers.  The
hand-written kernels themselves are held to their plain versions on the
card by tests/test_torch_cuda.py.

Tolerances are the repo's Pallas-vs-jnp ones: density rtol 1e-5, atol
1e-6 on values scaled by max|rho| (tests/test_spill.py); acceleration
rtol 1e-4, atol 1e-5 scaled by max|a| (tests/test_pallas_ops.py); drho/dt
the same against the jnp pair path, and atol 1.5e-3 against the Pallas
kernel, whose diffusion term uses approximate reciprocals
(tests/test_pallas_ops.py).  The sums run in another order in each
implementation.
"""

import numpy
import pytest
import torch

import jax.numpy as jnp

from tpgsd.sph import dam_break as ref_dam_break
from tpgsd.sph import pallas_ops
from tpgsd.sph.cells import build_cells as ref_build_cells
from tpgsd.sph.cells import build_cells_spill as ref_build_cells_spill
from tpgsd.sph.cells import neighbor_table as ref_neighbor_table
from tpgsd.sph.cells import scatter_to_cells as ref_scatter_to_cells
from tpgsd.sph.cells import scatter_to_cells_soa as ref_scatter_soa
from tpgsd.sph.kernels import WendlandC2
from tpgsd.sph.step import _accel_blocks as ref_accel_blocks
from tpgsd.sph.step import _accel_drho_blocks as ref_accel_drho_blocks
from tpgsd.sph.step import _density_blocks as ref_density_blocks
from tpgsd.sph.step import tait_pressure as ref_tait_pressure
from tpgsd_torch import _build
from tpgsd_torch.sph import ops
from tpgsd_torch.sph.cells import (
    build_cells,
    build_cells_spill,
    scatter_to_cells_soa,
)
from tpgsd_torch.sph.convert import grid_from_reference, params_from_reference
from tpgsd_torch.sph.step import tait_pressure

K = 24


def _spill_state(n_side=10, jitter=0.0, v_scale=0.0, seed=3):
    """Dam-break lattice at main-tier capacity K (its spill tier is
    occupied), optionally jittered and given seeded random velocities
    (which turn the viscosity term on)."""
    db = ref_dam_break(n_side=n_side, capacity=K)
    rng = numpy.random.default_rng(seed)
    x = numpy.asarray(db.state.x)
    dx = db.params.h / 1.3
    x = x + (jitter * dx) * rng.standard_normal(x.shape)
    v = v_scale * rng.standard_normal(x.shape)
    return x.astype(numpy.float32), v.astype(numpy.float32), db.grid, db.params


def _finish(rho, mask, params):
    rho = torch.where(mask, torch.clamp(rho, min=0.1 * params.rho0), params.rho0)
    return rho, torch.where(mask, tait_pressure(rho, params), 0.0)


def _assert_scaled_close(got, want, live, rtol, atol):
    got, want = numpy.asarray(got)[live], numpy.asarray(want)[live]
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def spill_case():
    """Both packages' spill layouts of the same input, with the JAX
    reference density and acceleration (Pallas interpret mode)."""
    x, v, grid_r, params_r = _spill_state()
    grid, params = grid_from_reference(grid_r), params_from_reference(params_r)
    xv = numpy.concatenate([x, v], axis=1)

    cells_r, sp_r = ref_build_cells_spill(jnp.asarray(x), grid_r, K)
    soa_a_r = ref_scatter_soa(jnp.asarray(xv), cells_r, grid_r)
    soa_b_r = ref_scatter_soa(
        jnp.asarray(xv), cells_r, grid_r, slot_base=K, capacity=K
    )
    cells, sp = build_cells_spill(torch.from_numpy(x), grid, K)
    soa_a = scatter_to_cells_soa(torch.from_numpy(xv), cells, grid)
    soa_b = scatter_to_cells_soa(
        torch.from_numpy(xv), cells, grid, slot_base=K, capacity=K
    )
    assert bool(sp.mask.any()), "the spill tier must be occupied"

    rho_r = pallas_ops.density_spill(
        soa_a_r[:3], cells_r.mask, soa_b_r[:3], sp_r.mask, grid_r, params_r,
        interpret=True, soa=True,
    )
    # one finished density/pressure, handed to BOTH acceleration passes
    c = grid.n_cells
    rho_a, p_a = _finish(torch.from_numpy(numpy.array(rho_r[0])), cells.mask[:c], params)
    rho_b, p_b = _finish(torch.from_numpy(numpy.array(rho_r[1])), sp.mask[:c], params)
    # at rest: the Pallas acceleration kernels' factorized reduction
    # drifts past the tolerance once velocities and jitter grow (ROADMAP
    # "Faults found"); test_accel_spill_viscosity_matches_jnp_reference
    # covers that regime against the JAX package's jnp pair path
    acc_r = pallas_ops.accel_spill(
        soa_a_r[:3], soa_a_r[3:], jnp.asarray(rho_a.numpy()),
        jnp.asarray(p_a.numpy()), cells_r.mask,
        soa_b_r[:3], soa_b_r[3:], jnp.asarray(rho_b.numpy()),
        jnp.asarray(p_b.numpy()), sp_r.mask,
        grid_r, params_r, interpret=True, soa=True,
    )
    out4_r = pallas_ops.accel_drho_spill(
        soa_a_r[:3], soa_a_r[3:], jnp.asarray(rho_a.numpy()),
        jnp.asarray(p_a.numpy()), cells_r.mask,
        soa_b_r[:3], soa_b_r[3:], jnp.asarray(rho_b.numpy()),
        jnp.asarray(p_b.numpy()), sp_r.mask,
        grid_r, params_r, delta_sph=0.1, interpret=True, soa=True,
    )
    return {
        "grid": grid, "params": params, "cells": cells, "sp": sp,
        "soa_a": soa_a, "soa_b": soa_b,
        "rho": (rho_a, rho_b), "p": (p_a, p_b),
        "rho_ref": [numpy.asarray(r) for r in rho_r],
        "acc_ref": [numpy.asarray(a) for a in acc_r],
        "out4_ref": [numpy.asarray(o) for o in out4_r],
        "live": (cells.mask[:c].numpy(), sp.mask[:c].numpy()),
    }


def test_density_spill_matches_reference(spill_case):
    s = spill_case
    got = ops.density_spill_plain(
        s["soa_a"][:3], s["cells"].mask, s["soa_b"][:3], s["sp"].mask,
        s["grid"], s["params"],
    )
    for tier in range(2):
        assert got[tier].shape == (s["grid"].n_cells, K)
        _assert_scaled_close(
            got[tier], s["rho_ref"][tier], s["live"][tier], 1e-5, 1e-6
        )


def test_accel_spill_matches_reference(spill_case):
    s = spill_case
    (rho_a, rho_b), (p_a, p_b) = s["rho"], s["p"]
    got = ops.accel_spill_plain(
        s["soa_a"][:3], s["soa_a"][3:], rho_a, p_a, s["cells"].mask,
        s["soa_b"][:3], s["soa_b"][3:], rho_b, p_b, s["sp"].mask,
        s["grid"], s["params"],
    )
    for tier in range(2):
        assert got[tier].shape == (s["grid"].n_cells, K, 3)
        _assert_scaled_close(
            got[tier], s["acc_ref"][tier], s["live"][tier], 1e-4, 1e-5
        )


def _spill_args(s):
    (rho_a, rho_b), (p_a, p_b) = s["rho"], s["p"]
    return (
        s["soa_a"][:3], s["soa_a"][3:], rho_a, p_a, s["cells"].mask,
        s["soa_b"][:3], s["soa_b"][3:], rho_b, p_b, s["sp"].mask,
        s["grid"], s["params"],
    )


def test_accel_drho_spill_matches_reference(spill_case):
    """At rest with delta-SPH on: the acceleration columns at the
    acceleration tolerance.  The drho column (pure diffusion here) is held
    at atol 4e-3, which bounds the REFERENCE's own error: on this input
    the Pallas kernel's approximate reciprocals put it 2.6e-3 of max|drho|
    away from the JAX package's own jnp pair path, past the 1.5e-3 that
    tests/test_pallas_ops.py measured on its input (ROADMAP "Faults
    found").  So that the loose bound cannot hide a fault of the port,
    the port must also lie nearer to the jnp path than the Pallas kernel
    does (it is within 2e-7, which
    test_accel_drho_spill_matches_jnp_reference holds at 1e-5)."""
    s = spill_case
    got = ops.accel_drho_spill_plain(*_spill_args(s), delta_sph=0.1)
    _, ref_args, live2 = _two_tier_and_jnp_inputs(0.0, 0.0)
    jnp_drho = numpy.asarray(ref_accel_drho_blocks(*ref_args, 0.1))[..., 3]
    for tier in range(2):
        assert got[tier].shape == (s["grid"].n_cells, K, 4)
        want, live = s["out4_ref"][tier], s["live"][tier]
        _assert_scaled_close(got[tier][..., :3], want[..., :3], live, 1e-4, 1e-5)
        assert numpy.abs(want[..., 3][live]).max() > 0
        _assert_scaled_close(got[tier][..., 3], want[..., 3], live, 1e-4, 4e-3)
        slots = slice(tier * K, (tier + 1) * K)
        assert (live2[:, slots] == live).all()
        exact = jnp_drho[:, slots][live]
        port_err = numpy.abs(got[tier][..., 3].numpy()[live] - exact).max()
        pallas_err = numpy.abs(want[..., 3][live] - exact).max()
        assert port_err < pallas_err


def test_accel_drho_spill_without_diffusion_is_still_at_rest(spill_case):
    """delta_sph = 0 at rest: every pair's v_ij . x_ij is 0, so drho/dt is
    exactly 0, and the acceleration columns are those of accel_spill."""
    s = spill_case
    got = ops.accel_drho_spill_plain(*_spill_args(s), delta_sph=0.0)
    acc = ops.accel_spill_plain(*_spill_args(s))
    for tier in range(2):
        assert not bool(got[tier][..., 3].any())
        assert torch.equal(got[tier][..., :3], acc[tier])


@pytest.mark.parametrize("delta", [0.0, 0.1])
def test_accel_drho_pairs_plain_matches_jnp_reference(delta):
    """The fused momentum + continuity pass against the JAX package's jnp
    pair blocks on the dam break with N(0, 0.1) velocities (the input of
    tests/test_pallas_ops.py::test_accel_drho_matches_jnp); every column
    scaled by its max, rtol 1e-4, atol 1e-5."""
    db = ref_dam_break(n_side=6, capacity=48)
    grid, params = grid_from_reference(db.grid), params_from_reference(db.params)
    c = grid.n_cells
    x = numpy.asarray(db.state.x)
    v = (numpy.random.RandomState(2).randn(*x.shape) * 0.1).astype(numpy.float32)
    xv = numpy.concatenate([x, v], axis=1)

    cells_r = ref_build_cells(jnp.asarray(x), db.grid)
    dense = ref_scatter_to_cells(jnp.asarray(xv), cells_r, db.grid)
    nbr = ref_neighbor_table(db.grid)
    rho = ref_density_blocks(
        dense[..., :3], cells_r.mask, nbr, db.params, WendlandC2, 32
    )
    rho = jnp.concatenate([rho, jnp.full((1, 48), db.params.rho0, rho.dtype)])
    rho = jnp.where(
        cells_r.mask, jnp.maximum(rho, 0.1 * db.params.rho0), db.params.rho0
    )
    p = jnp.where(cells_r.mask, ref_tait_pressure(rho, db.params), 0.0)
    want = numpy.asarray(
        ref_accel_drho_blocks(
            dense[..., :3], dense[..., 3:], rho, p, cells_r.mask, nbr,
            db.params, WendlandC2, 32, delta,
        )
    )

    cells = build_cells(torch.from_numpy(x), grid)
    soa = scatter_to_cells_soa(torch.from_numpy(xv), cells, grid)
    m = cells.mask[:c]
    assert (m.numpy() == numpy.asarray(cells_r.mask)[:c]).all()
    tier = (soa[:3], soa[3:], torch.from_numpy(numpy.array(rho[:c])),
            torch.from_numpy(numpy.array(p[:c])), m)
    got = ops.accel_drho_pairs_plain(*tier, *tier, grid, params, delta_sph=delta)
    assert got.shape == (4, c, 48)
    assert numpy.abs(want[..., 3]).max() > 0
    for col in range(4):
        _assert_scaled_close(got[col], want[..., col], m.numpy(), 1e-4, 1e-5)


def _two_tier_and_jnp_inputs(jitter, v_scale):
    """The port's two tiers of one input, and the same input in the JAX
    package's single-tier 2K layout, which is slot-identical to the two
    tiers side by side; both carry the port's finished density."""
    x, v, grid_r, params_r = _spill_state(jitter=jitter, v_scale=v_scale)
    grid, params = grid_from_reference(grid_r), params_from_reference(params_r)
    c = grid.n_cells
    xv = numpy.concatenate([x, v], axis=1)
    cells, sp = build_cells_spill(torch.from_numpy(x), grid, K)
    assert bool(sp.mask.any())
    soa_a = scatter_to_cells_soa(torch.from_numpy(xv), cells, grid)
    soa_b = scatter_to_cells_soa(
        torch.from_numpy(xv), cells, grid, slot_base=K, capacity=K
    )
    rho = ops.density_spill(
        soa_a[:3], cells.mask, soa_b[:3], sp.mask, grid, params
    )
    rho_a, p_a = _finish(rho[0], cells.mask[:c], params)
    rho_b, p_b = _finish(rho[1], sp.mask[:c], params)
    port_args = (
        soa_a[:3], soa_a[3:], rho_a, p_a, cells.mask,
        soa_b[:3], soa_b[3:], rho_b, p_b, sp.mask, grid, params,
    )

    grid2 = grid_r._replace(capacity=2 * K)
    cells2 = ref_build_cells(jnp.asarray(x), grid2)
    dense = ref_scatter_to_cells(jnp.asarray(xv), cells2, grid2)
    rho2 = numpy.concatenate(
        [torch.cat([rho_a, rho_b], 1).numpy(), numpy.full((1, 2 * K), params.rho0)]
    ).astype(numpy.float32)
    p2 = numpy.concatenate(
        [torch.cat([p_a, p_b], 1).numpy(), numpy.zeros((1, 2 * K))]
    ).astype(numpy.float32)
    ref_args = (
        dense[..., :3], dense[..., 3:], jnp.asarray(rho2), jnp.asarray(p2),
        cells2.mask, ref_neighbor_table(grid2), params_r, WendlandC2, 32,
    )
    live2 = numpy.asarray(cells2.mask)[:c]
    assert (numpy.asarray(sp.mask)[:c] == live2[:, K:]).all()
    return port_args, ref_args, live2


def test_accel_spill_viscosity_matches_jnp_reference():
    """Jittered lattice with N(0, 1) velocities: the two-tier acceleration
    against the JAX package's jnp pair path."""
    port_args, ref_args, live2 = _two_tier_and_jnp_inputs(0.05, 1.0)
    got = ops.accel_spill(*port_args)
    want = numpy.asarray(ref_accel_blocks(*ref_args))
    _assert_scaled_close(got[0], want[:, :K], live2[:, :K], 1e-4, 1e-5)
    _assert_scaled_close(got[1], want[:, K:], live2[:, K:], 1e-4, 1e-5)


@pytest.mark.parametrize(
    "jitter, v_scale", [(0.0, 0.0), (0.05, 1.0)], ids=["at_rest", "moving"]
)
def test_accel_drho_spill_matches_jnp_reference(jitter, v_scale):
    """The two-tier fused pass with delta-SPH on against the JAX package's
    jnp pair path, all four columns at rtol 1e-4, atol 1e-5 (scaled)."""
    port_args, ref_args, live2 = _two_tier_and_jnp_inputs(jitter, v_scale)
    got = ops.accel_drho_spill(*port_args, delta_sph=0.1)
    want = numpy.asarray(ref_accel_drho_blocks(*ref_args, 0.1))
    for col in range(4):
        _assert_scaled_close(
            got[0][..., col], want[:, :K, col], live2[:, :K], 1e-4, 1e-5
        )
        _assert_scaled_close(
            got[1][..., col], want[:, K:, col], live2[:, K:], 1e-4, 1e-5
        )


def test_cpu_wrappers_take_the_plain_version_without_launching(spill_case):
    s = spill_case
    grid, params = s["grid"], s["params"]
    (rho_a, rho_b), (p_a, p_b) = s["rho"], s["p"]
    a = (s["soa_a"][:3], s["soa_a"][3:], rho_a, p_a, s["cells"].mask)
    b = (s["soa_b"][:3], s["soa_b"][3:], rho_b, p_b, s["sp"].mask)
    ma, mb = a[4][: grid.n_cells], b[4][: grid.n_cells]
    ops.reset_launch_counts()
    pairs = [
        (ops.density_pairs(a[0], ma, b[0], mb, grid, params, cross=True),
         ops.density_pairs_plain(a[0], ma, b[0], mb, grid, params)),
        (ops.accel_pairs(*a[:4], ma, *b[:4], mb, grid, params),
         ops.accel_pairs_plain(*a[:4], ma, *b[:4], mb, grid, params)),
        (ops.accel_drho_pairs(*a[:4], ma, *b[:4], mb, grid, params, cross=True),
         ops.accel_drho_pairs_plain(*a[:4], ma, *b[:4], mb, grid, params)),
    ]
    for fn, plain, args in (
        (ops.density_spill, ops.density_spill_plain, (a[0], a[4], b[0], b[4])),
        (ops.accel_spill, ops.accel_spill_plain, a + b),
        (ops.accel_drho_spill, ops.accel_drho_spill_plain, a + b),
    ):
        pairs += zip(fn(*args, grid, params), plain(*args, grid, params))
    for got, want in pairs:
        assert torch.equal(got, want)
    assert set(ops.launch_counts.values()) == {0}


def test_pressure_plane_folds_the_reference_constant():
    params = params_from_reference(ref_dam_break(n_side=6).params)
    rho = torch.tensor([1000.0, 1010.0], dtype=torch.float32)
    p = tait_pressure(rho, params)
    cfold, _ = pallas_ops._accel_folds(params, pallas_ops.WendlandC2)
    want = cfold * p.numpy() / (rho.numpy() ** 2 + 1e-30)
    numpy.testing.assert_allclose(
        ops.pressure_plane(rho, p, params).numpy(), want, rtol=1e-6
    )


def test_kernel_capacity_gate():
    """Up to 64 slots the two-tier kernels; past it the wide kernels, for
    the single tier only; past their limit nothing."""
    grid = grid_from_reference(ref_dam_break(n_side=6, capacity=32).grid)
    assert ops.spill_supported(grid)
    assert ops.spill_supported(grid._replace(capacity=64))
    assert not ops.spill_supported(grid._replace(capacity=72))
    for capacity in (32, 72, 96, 128, 256, ops.MAX_WIDE_CAPACITY):
        wide = grid._replace(capacity=capacity)
        assert ops.supported(wide) and ops.accel_drho_supported(wide)
        key = ops._role_key("accel", wide, "self")
        assert key == ("accel_wide" if capacity > 64 else "accel_self")
    past = grid._replace(capacity=ops.MAX_WIDE_CAPACITY + 8)
    assert not ops.supported(past) and not ops.accel_drho_supported(past)
    with pytest.raises(ValueError, match="capacity <= 1024; got 1032"):
        ops._check_launch(past, (), (), ())


def test_non_cpu_tensor_with_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a tensor off the CPU goes to the kernel route, and a
    failed build raises instead of running the plain version."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-toolkit"))
    grid = grid_from_reference(ref_dam_break(n_side=6, capacity=32).grid)
    c, k = grid.n_cells, grid.capacity
    x = torch.empty((3, c, k), device="meta")
    m = torch.empty((c, k), dtype=torch.bool, device="meta")
    params = params_from_reference(ref_dam_break(n_side=6).params)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.density_pairs(x, m, x, m, grid, params)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.density_spill(x, m, x, m, grid, params)
    f = torch.empty((c, k), device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.accel_drho_pairs(x, x, f, f, m, x, x, f, f, m, grid, params)
    assert set(ops.launch_counts.values()) == {0}
    assert _build._lib is None


@pytest.mark.parametrize(
    "scenario, capacity, want",
    [("dam_break", 32, 4), ("still_box", 48, 4), ("taylor_green", 64, 14),
     ("dam_break", 8, 16)],
    ids=["dam_break", "still_box", "taylor_green", "capped_by_K"],
)
def test_tile_cells_fills_one_round_of_centres(scenario, capacity, want):
    """The two-tier kernels' tile: a fluid at rest fills T cells with at
    most 128 live centres (a cell holds at most K); 2-D cells hold fewer
    particles, so their tiles are longer."""
    from tpgsd_torch.sph import scenarios
    from tpgsd_torch.sph.dam_break import dam_break

    build = dam_break if scenario == "dam_break" else getattr(
        scenarios, scenario)
    sc = build(n_side=12, capacity=capacity, device="cpu")
    tile = ops.tile_cells(sc.grid, sc.params)
    assert tile == want
    per_cell = min(capacity, sc.params.rho0 * sc.grid.cell_size
                   ** sc.params.dim / sc.params.mass)
    assert tile == ops.MAX_TILE or (
        tile * per_cell <= 128 < (tile + 1) * per_cell)


def test_forced_tile_is_range_checked():
    """Every family (density, accel, accel_drho) takes the same tile at
    any capacity, past 64 slots too: ``tile_cells`` by default, 1 .. 16
    forced, and a tile outside that raises."""
    from tpgsd_torch.sph.dam_break import dam_break

    db = dam_break(n_side=6, capacity=24, device="cpu")
    grid, params = db.grid, db.params
    for capacity in (24, 64, 96, ops.MAX_WIDE_CAPACITY):
        at = grid._replace(capacity=capacity)
        assert ops._tile(at, params, None) == ops.tile_cells(at, params)
        for tile in range(1, ops.MAX_TILE + 1):
            assert ops._tile(at, params, tile) == tile
        for bad in (0, ops.MAX_TILE + 1):
            with pytest.raises(ValueError, match="tile must be 1 .. 16"):
                ops._tile(at, params, bad)
