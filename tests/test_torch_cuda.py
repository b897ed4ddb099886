"""The port's CUDA pair kernels on the card: each against its plain
version, the launch counts, the operand checks, and the failed-build
rule.  Every test here needs an NVIDIA GPU and skips without one; the
file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances are the repo's Pallas-vs-jnp ones: density rtol 1e-5, atol
1e-6 and acceleration and drho/dt rtol 1e-4, atol 1e-5, on values scaled
by their max; the kernels sum in another order than the plain version.
"""

import numpy
import pytest
import torch

from tpgsd_torch import _build
from tpgsd_torch.entry import entry
from tpgsd_torch.sph import dam_break, init_density, make_step_fn, ops
from tpgsd_torch.sph import kernels as port_kernels
from tpgsd_torch.sph.cells import build_cells_spill, scatter_to_cells_soa
from tpgsd_torch.sph.step import tait_pressure

K = 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _scaled_close(got, want, live, rtol, atol):
    got, want = got.cpu().numpy()[live], want.cpu().numpy()[live]
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


def _spill_tiers(dev, seed=3):
    """Both tiers of a jittered dam break at K = 24 (spill tier occupied)
    with N(0, 1) velocities, plus finished density and pressure."""
    db = dam_break(n_side=10, capacity=K, device="cpu")
    rng = numpy.random.default_rng(seed)
    x = db.state.x.numpy()
    x = x + (0.05 * db.params.h / 1.3) * rng.standard_normal(x.shape)
    v = rng.standard_normal(x.shape)
    xv = torch.from_numpy(numpy.concatenate([x, v], 1).astype(numpy.float32))
    xv = xv.to(dev)
    grid, params = db.grid, db.params
    cells, sp = build_cells_spill(xv[:, :3].contiguous(), grid, K)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=K, capacity=K)
    c = grid.n_cells
    ma, mb = cells.mask[:c], sp.mask[:c]
    assert bool(mb.any()), "the spill tier must be occupied"
    rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, params)

    def finish(r, m):
        r = torch.where(m, torch.clamp(r, min=0.1 * params.rho0), params.rho0)
        return r, torch.where(m, tait_pressure(r, params), 0.0)

    (ra, pa), (rb, pb) = finish(rho[0], ma), finish(rho[1], mb)
    return grid, params, (a[:3], a[3:], ra, pa, ma), (b[:3], b[3:], rb, pb, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["WendlandC2", "CubicSpline"])
def test_spill_kernels_match_plain(cuda, kernel):
    kernel = getattr(port_kernels, kernel)
    grid, params, a, b = _spill_tiers(cuda)
    live = (a[4].cpu().numpy(), b[4].cpu().numpy())
    ops.reset_launch_counts()
    args = (a[0], a[4], b[0], b[4], grid, params)
    got = ops.density_spill(*args, kernel=kernel)
    want = ops.density_spill_plain(*args, kernel=kernel)
    for tier in range(2):
        _scaled_close(got[tier], want[tier], live[tier], 1e-5, 1e-6)
    got = ops.accel_spill(*a, *b, grid, params, kernel=kernel)
    want = ops.accel_spill_plain(*a, *b, grid, params, kernel=kernel)
    torch.cuda.synchronize()
    for tier in range(2):
        _scaled_close(got[tier], want[tier], live[tier], 1e-4, 1e-5)
    assert ops.launch_counts == {
        "density_self": 2, "density_cross": 2,
        "accel_self": 2, "accel_cross": 2,
        "accel_drho_self": 0, "accel_drho_cross": 0,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("delta_sph", [0.0, 0.1])
@pytest.mark.parametrize("kernel", ["WendlandC2", "CubicSpline"])
def test_accel_drho_kernel_matches_plain(cuda, kernel, delta_sph):
    """The fused momentum + continuity kernel at K = 24 with the spill
    tier occupied: two-tier sums and each role on its own, all four
    columns scaled by their max."""
    kernel = getattr(port_kernels, kernel)
    grid, params, a, b = _spill_tiers(cuda)
    live = (a[4].cpu().numpy(), b[4].cpu().numpy())
    ops.reset_launch_counts()
    kw = {"kernel": kernel, "delta_sph": delta_sph}
    got = ops.accel_drho_spill(*a, *b, grid, params, **kw)
    want = ops.accel_drho_spill_plain(*a, *b, grid, params, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["accel_drho_self"] == 2
    assert ops.launch_counts["accel_drho_cross"] == 2
    for tier in range(2):
        assert got[tier].shape == (grid.n_cells, K, 4)
        for col in range(4):
            _scaled_close(got[tier][..., col], want[tier][..., col],
                          live[tier], 1e-4, 1e-5)
    for cen, nbr, cross, centre_live in (
        (a, a, False, live[0]), (a, b, True, live[0]), (b, a, True, live[1])
    ):
        got = ops.accel_drho_pairs(*cen, *nbr, grid, params, cross=cross, **kw)
        want = ops.accel_drho_pairs_plain(*cen, *nbr, grid, params, **kw)
        assert not bool(got[:, ~cen[4]].any()), "dead centre slots must be 0"
        for col in range(4):
            if bool(want[col].any()):
                _scaled_close(got[col], want[col], centre_live, 1e-4, 1e-5)
    assert ops.launch_counts["accel_drho_self"] == 3
    assert ops.launch_counts["accel_drho_cross"] == 4


@pytest.mark.cuda
def test_kernel_operands_are_checked(cuda):
    grid, params, a, _ = _spill_tiers(cuda)
    x, m = a[0], a[4]
    with pytest.raises(ValueError, match="float32"):
        ops.density_pairs(x.double(), m, x, m, grid, params)
    with pytest.raises(ValueError, match="contiguous"):
        bad = x.transpose(1, 2).contiguous().transpose(1, 2)
        ops.density_pairs(bad, m, x, m, grid, params)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.density_pairs(x, m.cpu(), x, m, grid, params)
    with pytest.raises(ValueError, match="capacity"):
        ops.density_pairs(x, m, x, m, grid._replace(capacity=72), params)


@pytest.mark.cuda
def test_cuda_tensor_with_failed_build_raises(monkeypatch, tmp_path, cuda):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-toolkit"))
    db = dam_break(n_side=6, capacity=32, device=cuda)
    c, k = db.grid.n_cells, db.grid.capacity
    x = torch.zeros((3, c, k), device=cuda)
    m = torch.zeros((c, k), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.density_pairs(x, m, x, m, db.grid, db.params)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "capacity, spill", [(72, "auto"), (72, True), (32, False)]
)
def test_auto_policy_on_cuda_never_runs_the_plain_passes(cuda, capacity, spill):
    db = dam_break(n_side=6, capacity=capacity, device=cuda)
    with pytest.raises(NotImplementedError, match="queue 2, kernels 7-9"):
        make_step_fn(db.grid, db.params, spill=spill, device=cuda)
    step = make_step_fn(
        db.grid, db.params, use_kernels=False, spill=spill, device=cuda
    )
    assert not step.resolved["use_kernels"]


@pytest.mark.cuda
def test_kernel_step_matches_plain_step(cuda):
    step_k, (state,) = entry(n_side=10, device=cuda)
    assert step_k.resolved == {
        "use_kernels": True, "spill": True, "density_mode": "summation"
    }
    db = dam_break(n_side=10, capacity="auto", capacity_headroom=1.15,
                   device=cuda)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    step_p = make_step_fn(
        grid, db.params, use_kernels=False, spill=True, device=cuda
    )
    for _ in range(3):
        state, _ = step_k(state)
    ops.reset_launch_counts()
    sk, (rho_k, _, _) = step_k(state)
    sp, (rho_p, _, _) = step_p(state)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts.items() if "drho" not in k} == {
        "density_self": 2, "density_cross": 2, "accel_self": 2, "accel_cross": 2
    }
    assert ops.launch_counts["accel_drho_self"] == 0
    numpy.testing.assert_allclose(
        sk.x.cpu().numpy(), sp.x.cpu().numpy(), rtol=1e-5, atol=1e-6
    )
    everything = numpy.ones(rho_p.shape, bool)
    _scaled_close(rho_k, rho_p, everything, 1e-5, 1e-6)


@pytest.mark.cuda
def test_kernel_continuity_step_matches_plain_step(cuda):
    """One continuity step through the fused kernel against one through
    the plain passes, from a state three kernel steps into the run with
    seeded N(0, 0.1) velocities on top.  The CHANGE of the carried density
    is held too, scaled by its max (rtol 1e-4, atol 1e-5, plus 2.5e-4 for
    the rounding of rho near 1000 to float32): a step whose drho/dt was
    zero or lacked a term would pass a tolerance relative to rho."""
    step_k, (state,) = entry(n_side=10, device=cuda, density_mode="continuity")
    assert step_k.resolved == {
        "use_kernels": True, "spill": True, "density_mode": "continuity"
    }
    db = dam_break(n_side=10, capacity="auto", capacity_headroom=1.15,
                   device=cuda)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    step_p = make_step_fn(
        grid, db.params, use_kernels=False, spill=True,
        density_mode="continuity", device=cuda,
    )
    for _ in range(3):
        state, _ = step_k(state)
    rng = numpy.random.default_rng(5)
    dv = 0.1 * rng.standard_normal(tuple(state.v.shape)).astype(numpy.float32)
    state = state._replace(v=state.v + torch.from_numpy(dv).to(cuda))
    ops.reset_launch_counts()
    sk, _ = step_k(state)
    sp, _ = step_p(state)
    torch.cuda.synchronize()
    assert ops.launch_counts == {
        "density_self": 0, "density_cross": 0, "accel_self": 0,
        "accel_cross": 0, "accel_drho_self": 2, "accel_drho_cross": 2,
    }
    numpy.testing.assert_allclose(
        sk.x.cpu().numpy(), sp.x.cpu().numpy(), rtol=1e-5, atol=1e-6
    )
    numpy.testing.assert_allclose(
        sk.rho.cpu().numpy(), sp.rho.cpu().numpy(), rtol=1e-4, atol=1e-2
    )
    d_k = (sk.rho - state.rho).cpu().numpy()
    d_p = (sp.rho - state.rho).cpu().numpy()
    scale = float(numpy.abs(d_p).max())
    assert scale > 100 * 2.5e-4, "the step must change the carried density"
    numpy.testing.assert_allclose(
        d_k / scale, d_p / scale, rtol=1e-4, atol=1e-5 + 2.5e-4 / scale
    )


@pytest.mark.cuda
def test_init_density_on_the_card_matches_the_plain_pass(cuda):
    db = dam_break(n_side=10, capacity=K, device=cuda)
    ops.reset_launch_counts()
    got = init_density(db.state, db.grid, db.params)
    assert ops.launch_counts["density_self"] == 2
    assert ops.launch_counts["density_cross"] == 2
    want = init_density(
        db.state._replace(x=db.state.x.cpu(), v=db.state.v.cpu()),
        db.grid._replace(capacity=2 * K), db.params, device="cpu",
    )
    numpy.testing.assert_allclose(
        got.rho.cpu().numpy(), want.rho.numpy(), rtol=1e-5
    )
