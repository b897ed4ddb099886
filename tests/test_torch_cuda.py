"""The port's CUDA pair kernels on the card: each against its plain
version (the tile kernels ``density_pairs_kernel`` and
``accel_pairs_kernel<kDrho>`` on the edges of their tiles, up to 64 slots
and, for momentum, past them up to K = 1024 with ranges staged in pieces,
the wide single-tier roles at K = 96, 128 and 256 with prefix and
arbitrary masks, the ghost-halo route against the wrapped-table route),
the slab step (kernel against plain, silent steps without a host sync,
a frame streamed through the side stream and the ring), the slab, 2-D
and 3-D block decompositions (kernel against plain, an adaptive rollout
without a host sync),
the launch counts, the cell build's runs against the CPU's,
the operand checks, and the failed-build rule.  Every test here needs an NVIDIA GPU and skips without one; the
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
from tpgsd_torch.sph import (
    SPHParams,
    SPHState,
    dam_break,
    energy_rate,
    init_density,
    make_grid,
    make_step_fn,
    ops,
    still_box,
    taylor_green,
)
from tpgsd_torch.sph import kernels as port_kernels
from tpgsd_torch.sph.cells import (
    build_cells,
    build_cells_spill,
    scatter_to_cells_soa,
    sorted_runs,
)
from tpgsd_torch.sph.step import tait_pressure

K = 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _launched():
    """The roles launched since the counts were reset."""
    return {k: v for k, v in ops.launch_counts.items() if v}


def _scaled_close(got, want, live, rtol, atol):
    got, want = got.cpu().numpy()[live], want.cpu().numpy()[live]
    scale = float(numpy.abs(want).max())
    if scale == 0.0:  # a plane that is zero (z of a 2-D grid) stays zero
        assert not got.any()
        return
    numpy.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


def _spill_tiers(dev, seed=3, k=K):
    """Both tiers of a jittered dam break at K = 24 (spill tier occupied;
    or at capacity ``k``) with N(0, 1) velocities, plus finished density
    and pressure."""
    db = dam_break(n_side=10, capacity=k, device="cpu")
    rng = numpy.random.default_rng(seed)
    x = db.state.x.numpy()
    x = x + (0.05 * db.params.h / 1.3) * rng.standard_normal(x.shape)
    v = rng.standard_normal(x.shape)
    xv = torch.from_numpy(numpy.concatenate([x, v], 1).astype(numpy.float32))
    xv = xv.to(dev)
    grid, params = db.grid, db.params
    cells, sp = build_cells_spill(xv[:, :3].contiguous(), grid, k)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    c = grid.n_cells
    ma, mb = cells.mask[:c], sp.mask[:c]
    assert k != K or bool(mb.any()), "the spill tier must be occupied"
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
    assert _launched() == {
        "density_self": 2, "density_cross": 2,
        "accel_self": 2, "accel_cross": 2,
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
    with pytest.raises(ValueError, match="capacity <= 1024"):
        ops.density_pairs(
            x, m, x, m, grid._replace(capacity=ops.MAX_WIDE_CAPACITY + 8),
            params,
        )


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
    "capacity, spill, role",
    [(72, "auto", "wide"), (72, True, None), (32, False, "self")],
)
def test_auto_policy_on_cuda_never_runs_the_plain_passes(
    cuda, capacity, spill, role
):
    """On the card "auto" means a kernel: the single tier launches the
    wide kernels past 64 slots and the self role up to it; the two-tier
    layout past 64 slots raises."""
    db = dam_break(n_side=6, capacity=capacity, device=cuda)
    if role is None:
        with pytest.raises(ValueError, match="two-tier spill kernels"):
            make_step_fn(db.grid, db.params, spill=spill, device=cuda)
        return
    step = make_step_fn(db.grid, db.params, spill=spill, device=cuda)
    assert step.resolved == {
        "use_kernels": True, "spill": False, "density_mode": "summation"
    }
    ops.reset_launch_counts()
    step(db.state)
    assert _launched() == {"density_" + role: 1, "accel_" + role: 1}
    plain = make_step_fn(
        db.grid, db.params, use_kernels=False, spill=spill, device=cuda
    )
    assert not plain.resolved["use_kernels"]


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
    assert _launched() == {
        "density_self": 2, "density_cross": 2, "accel_self": 2, "accel_cross": 2
    }
    # the plain step's rows come from the twin, not the row kernel
    assert ops.row_launch_counts == {"slot_rows": 1}
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
    assert _launched() == {"accel_drho_self": 2, "accel_drho_cross": 2}
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


# --------------------------------------------------------------------------
# the tiles of the two-tier kernels (K <= 64)
# --------------------------------------------------------------------------


def _tile_case(dev, case):
    """``(grid, params, tiers, tiles)`` of one edge of the tile walk:
    ``tiers`` holds one or two tiers ``(x, v, rho, p, mask)``, ``tiles``
    the cells per CTA to run (``None``: the wrapper's rule)."""
    if case.startswith("arbitrary"):
        k = int(case[len("arbitrary"):])
        grid, params, a = _cloud_tier(dev, k, arbitrary=True, seed=7)
        _, _, b = _cloud_tier(dev, k, arbitrary=True, seed=8)
        return grid, params, (a, b), (None,)
    if case == "2d":
        sc = taylor_green(n_side=24, capacity=16, device="cpu")
        grid, params = sc.grid, sc.params
        assert grid.dims[2] == 1
        xv = torch.cat([sc.state.x, sc.state.v], 1).to(dev)
    elif case == "ragged":
        grid, params, a, b = _spill_tiers(dev)
        assert grid.n_cells % 7 and grid.n_cells % 11
        return grid, params, (a, b), (1, 7, 11)
    else:  # "dense": a tile of 16 cells of about 27 live slots
        sc, state = _periodic_box(dev)
        grid, params = sc.grid._replace(capacity=48), sc.params
        xv = torch.cat([state.x, state.v], 1)
    cells = build_cells(xv[:, :3].contiguous(), grid)
    assert int(cells.overflow) == 0
    soa = scatter_to_cells_soa(xv, cells, grid)
    m = cells.mask[: grid.n_cells]
    rho = ops.density_plain(soa[:3], m, grid, params)
    tier = (soa[:3], soa[3:], *_finish(rho, m, params), m)
    if case == "dense":
        assert int(m[:16].sum()) > 128, "the first tile needs a second round"
        return grid, params, (tier,), (16,)
    return grid, params, (tier,), (None, 5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["arbitrary32", "arbitrary64", "2d", "ragged", "dense"]
)
def test_tile_kernels_match_plain(cuda, case):
    """``density_pairs``, ``accel_pairs`` and ``accel_drho_pairs`` in each
    role their tiers give (self; with two tiers also both cross roles)
    against their plain versions: arbitrary masks at K = 32 and 64, a 2-D
    grid (nz = 1), a cell count that is not a multiple of T, and a tile
    with more than 128 live centres.  Every output plane scaled by its
    max; dead centre slots are exactly 0."""
    grid, params, tiers, tiles = _tile_case(cuda, case)
    pairs = [(t, t, False) for t in tiers]
    if len(tiers) == 2:
        pairs += [(tiers[0], tiers[1], True), (tiers[1], tiers[0], True)]
    ops.reset_launch_counts()
    n = 0
    for tile in tiles:
        for cen, nbr, cross in pairs:
            live = cen[4].cpu().numpy()
            got = ops.density_pairs(cen[0], cen[4], nbr[0], nbr[4], grid,
                                    params, cross=cross, tile=tile)
            want = ops.density_pairs_plain(cen[0], cen[4], nbr[0], nbr[4],
                                           grid, params)
            assert not bool(got[~cen[4]].any())
            _scaled_close(got, want, live, 1e-5, 1e-6)
            for fn, plain, kw in (
                (ops.accel_pairs, ops.accel_pairs_plain, {}),
                (ops.accel_drho_pairs, ops.accel_drho_pairs_plain,
                 {"delta_sph": 0.1}),
            ):
                got = fn(*cen, *nbr, grid, params, cross=cross, tile=tile,
                         **kw)
                want = plain(*cen, *nbr, grid, params, **kw)
                assert not bool(got[:, ~cen[4]].any())
                for col in range(got.shape[0]):
                    _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
            n += 1
    torch.cuda.synchronize()
    roles = {"self": sum(not c for *_, c in pairs) * len(tiles)}
    roles["cross"] = n - roles["self"]
    assert _launched() == {
        "%s_%s" % (f, r): v for f in ("density", "accel", "accel_drho")
        for r, v in roles.items() if v
    }


@pytest.mark.cuda
def test_tile_shared_bytes(cuda):
    """A tile launch stages each particle of its T + 2 cells as one float4
    (density: x, y, z) or two (momentum: x, v, rho, pt), a budget of
    (T + 2) min(K, 64) live particles: past 64 slots every family asks
    for what it asks for at K = 64, up to K = 1024."""
    db = dam_break(n_side=8, capacity=32, device="cpu")
    grid, params = db.grid, db.params
    for family, staged in (("density", 16), ("accel", 32), ("accel_drho", 32)):
        assert ops.tile_shared_bytes(family, grid, params, 7) == (
            staged * 9 * 32)
    t = ops.tile_cells(grid, params)
    assert ops.tile_shared_bytes("density", grid, params) == (
        16 * (t + 2) * 32)
    for family, staged in (("density", 16), ("accel", 32), ("accel_drho", 32)):
        for tile in (1, 7, 16):
            at = [ops.tile_shared_bytes(family, grid._replace(capacity=k),
                                        params, tile)
                  for k in (64, 96, 128, ops.MAX_WIDE_CAPACITY)]
            assert at == [staged * (tile + 2) * 64] * 4
    wide = grid._replace(capacity=96)
    assert ops.tile_shared_bytes("density", wide, params) == (
        16 * (ops.tile_cells(wide, params) + 2) * 64)
    assert ops.tile_shared_bytes("density", wide, params, 7) == 9216
    assert ops.tile_shared_bytes(
        "accel", grid._replace(capacity=ops.MAX_WIDE_CAPACITY), params,
        ops.MAX_TILE) <= 48 * 1024


# --------------------------------------------------------------------------
# the wide single-tier kernels (K > 64) and the periodic ghost halo
# --------------------------------------------------------------------------


def _finish(rho, m, params):
    rho = torch.where(m, torch.clamp(rho, min=0.1 * params.rho0), params.rho0)
    return rho, torch.where(m, tait_pressure(rho, params), 0.0)


def _cloud_tier(dev, capacity, arbitrary, seed=7, n_dense=800, side=0.22,
                h=0.06):
    """One tier ``(x, v, rho, p, mask)`` of a random cloud of 3800
    particles in the unit box with a dense corner (by default ``n_dense``
    = 800 of them in a cube of side 0.22, so that cells there hold about
    150 particles, the others about 6, and wide cells have several live
    groups of 32 slots and most have one), with N(0, 1) velocities, on
    cells of side ``2 h``.  ``arbitrary`` permutes the slots of every
    cell, which turns the prefix masks into arbitrary ones."""
    rng = numpy.random.default_rng(seed)
    x = rng.uniform(0.02, 0.98, (3800, 3))
    x[:n_dense] = 0.03 + side * rng.uniform(0, 1, (n_dense, 3))
    v = rng.standard_normal(x.shape)
    xv = torch.from_numpy(numpy.concatenate([x, v], 1).astype(numpy.float32))
    xv = xv.to(dev)
    grid = make_grid((0, 0, 0), (1, 1, 1), 2 * h, capacity)
    params = SPHParams(mass=1000.0 / 3800, h=h, dt=1e-4, rho0=1000.0)
    cells = build_cells(xv[:, :3].contiguous(), grid)
    soa = scatter_to_cells_soa(xv, cells, grid)
    m = cells.mask[: grid.n_cells]
    if arbitrary:
        perm = torch.from_numpy(
            rng.permuted(numpy.tile(numpy.arange(capacity), (grid.n_cells, 1)),
                         axis=1)
        ).to(dev)
        m = torch.gather(m, 1, perm)
        soa = torch.gather(soa, 2, perm.expand(6, -1, -1)).contiguous()
        assert not bool(m[:, 0].all()), "the masks must not be prefixes"
    rho = ops.density_plain(soa[:3], m, grid, params)
    rho, p = _finish(rho, m, params)
    return grid, params, (soa[:3], soa[3:], rho, p, m)


@pytest.mark.cuda
@pytest.mark.parametrize("arbitrary", [False, True], ids=["prefix", "arbitrary"])
@pytest.mark.parametrize("capacity", [96, 128, 256])
def test_wide_kernels_match_plain(cuda, capacity, arbitrary):
    """Each wide role against its plain version, every output plane scaled
    by its max; dead centre slots are exactly 0."""
    grid, params, tier = _cloud_tier(cuda, capacity, arbitrary)
    x, m = tier[0], tier[4]
    live = m.cpu().numpy()
    assert live[:, 64:].any(), "some cell must fill its third group of slots"
    ops.reset_launch_counts()
    for kernel in (port_kernels.WendlandC2, port_kernels.CubicSpline):
        got = ops.density(x, m, grid, params, kernel=kernel)
        want = ops.density_plain(x, m, grid, params, kernel=kernel)
        assert not bool(got[~m].any())
        _scaled_close(got, want, live, 1e-5, 1e-6)
        got = ops.accel(*tier, grid, params, kernel=kernel)
        want = ops.accel_plain(*tier, grid, params, kernel=kernel)
        assert got.shape == (3, grid.n_cells, capacity)
        assert not bool(got[:, ~m].any())
        for col in range(3):
            _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
        for delta_sph in (0.0, 0.1):
            kw = {"kernel": kernel, "delta_sph": delta_sph}
            got = ops.accel_drho(*tier, grid, params, **kw)
            want = ops.accel_drho_plain(*tier, grid, params, **kw)
            assert got.shape == (4, grid.n_cells, capacity)
            assert not bool(got[:, ~m].any())
            for col in range(4):
                _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
    torch.cuda.synchronize()
    assert _launched() == {
        "density_wide": 2, "accel_wide": 2, "accel_drho_wide": 4
    }


def _most_live_in_a_range(live, dims, tile):
    """The largest live count of the id ranges a launch at ``tile`` cells
    per CTA stages: T + 2 consecutive cell ids per (dx, dy) offset of
    each tile, clipped to the grid (host side, from the masks)."""
    nx, ny, nz = dims
    c = nx * ny * nz
    before = numpy.concatenate([[0], numpy.cumsum(live.sum(axis=1))])
    most = 0
    for c0 in range(0, c, tile):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                lo = c0 + (dx * ny + dy) * nz - 1
                a, b = min(max(lo, 0), c), min(max(lo + tile + 2, 0), c)
                most = max(most, int(before[b] - before[a]))
    return most


def _wide_tile_case(dev, case):
    """``(grid, params, tier, tiles)`` of one edge of the tile kernels
    past 64 slots: ``tier`` is ``(x, v, rho, p, mask)``, ``tiles``
    the cells per CTA to run (``None``: the wrapper's rule)."""
    if case == "k1024":  # 4 x 4 x 4 cells, about 800 particles in one
        grid, params, tier = _cloud_tier(dev, ops.MAX_WIDE_CAPACITY, True,
                                         seed=9, h=0.12)
        return grid, params, tier, (None, 1, 16)
    if case.startswith("dense"):  # cells of up to about 200 particles
        grid, params, tier = _cloud_tier(dev, 256, case == "dense", seed=10,
                                         n_dense=3000, side=0.30)
        return grid, params, tier, (1, 7, 16)
    if case == "2d":
        sc = taylor_green(n_side=24, capacity=72, device="cpu")
        assert sc.grid.dims[2] == 1
    else:  # "ragged": a dam break of 144 cells at K = 96
        sc = dam_break(n_side=10, capacity=96, device="cpu")
    grid, params = sc.grid, sc.params
    xv = torch.cat([sc.state.x, sc.state.v], 1).to(dev)
    if case == "ragged":  # the dam break starts at rest
        rng = numpy.random.default_rng(12)
        xv[:, 3:] = torch.from_numpy(
            rng.standard_normal((sc.n, 3)).astype(numpy.float32)).to(dev)
    cells = build_cells(xv[:, :3].contiguous(), grid)
    assert int(cells.overflow) == 0
    soa = scatter_to_cells_soa(xv, cells, grid)
    m = cells.mask[: grid.n_cells]
    rho = ops.density_plain(soa[:3], m, grid, params)
    tier = (soa[:3], soa[3:], *_finish(rho, m, params), m)
    assert grid.n_cells % 7 and grid.n_cells % 11
    return grid, params, tier, (None, 1, 7, 11, 16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["k1024", "dense", "dense_prefix", "2d", "ragged"])
def test_tiles_past_64_slots_match_plain(cuda, case):
    """``density_pairs``, ``accel_pairs`` and ``accel_drho_pairs`` past
    64 slots (the tile kernels' wide instances that serve
    ``density_wide``, ``accel_wide`` and ``accel_drho_wide``) against
    their plain versions at forced tiles: K = 1024 on a small grid; a
    cloud whose densest id ranges hold more than twice the staging budget
    of a T = 1 tile (so they are staged in three or more pieces) and
    whose densest cells more than 128 live centres (a second round), with
    arbitrary and prefix masks; a 2-D grid; a cell count that is not a
    multiple of T.  Both smoothing kernels, delta-SPH 0 and 0.1; density
    at rtol 1e-5, atol 1e-6 and momentum at rtol 1e-4, atol 1e-5, every
    output plane scaled by its max; dead centre slots are exactly 0."""
    grid, params, tier, tiles = _wide_tile_case(cuda, case)
    m = tier[4]
    live = m.cpu().numpy()
    assert grid.capacity > ops.MAX_CAPACITY
    if case in ("k1024", "dense", "dense_prefix"):
        assert int(live.sum()) == 3800, "no particle may overflow"
        # live particles a T = 1 tile stages at once (32 B each for
        # momentum, 16 B for density: the same budget)
        cap = ops.tile_shared_bytes("accel", grid, params, 1) // 32
        assert cap == ops.tile_shared_bytes("density", grid, params, 1) // 16
        assert _most_live_in_a_range(live, grid.dims, 1) > 2 * cap
        assert int(live.sum(axis=1).max()) > 128
    if case == "k1024":
        assert live[:, ops.MAX_WIDE_CAPACITY // 2:].any()
    if case == "dense_prefix":
        assert not (live[:, 1:] & ~live[:, :-1]).any(), "prefix masks"
    ops.reset_launch_counts()
    x = tier[0]
    for kernel in (port_kernels.WendlandC2, port_kernels.CubicSpline):
        want = ops.density_pairs_plain(x, m, x, m, grid, params, kernel=kernel)
        for tile in tiles:
            got = ops.density_pairs(x, m, x, m, grid, params, kernel=kernel,
                                    tile=tile)
            assert not bool(got[~m].any()), "dead centre slots"
            _scaled_close(got, want, live, 1e-5, 1e-6)
        for fn, plain, kw in (
            (ops.accel_pairs, ops.accel_pairs_plain, {}),
            (ops.accel_drho_pairs, ops.accel_drho_pairs_plain,
             {"delta_sph": 0.0}),
            (ops.accel_drho_pairs, ops.accel_drho_pairs_plain,
             {"delta_sph": 0.1}),
        ):
            want = plain(*tier, *tier, grid, params, kernel=kernel, **kw)
            for tile in tiles:
                got = fn(*tier, *tier, grid, params, kernel=kernel, tile=tile,
                         **kw)
                assert not bool(got[:, ~m].any()), "dead centre slots"
                for col in range(got.shape[0]):
                    _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
    torch.cuda.synchronize()
    assert _launched() == {"density_wide": 2 * len(tiles),
                           "accel_wide": 2 * len(tiles),
                           "accel_drho_wide": 4 * len(tiles)}


def _periodic_box(dev, seed=11):
    """``still_box(n_side=12)`` (4 x 4 x 4 cells of about 27 particles)
    with a jitter of 5% of the spacing and N(0, 0.5) velocities."""
    sc = still_box(n_side=12, device="cpu")
    rng = numpy.random.default_rng(seed)
    x = sc.state.x.numpy()
    x = x + (0.05 / 12) * rng.standard_normal(x.shape)
    v = 0.5 * rng.standard_normal(x.shape)
    state = SPHState(
        x=torch.from_numpy(x.astype(numpy.float32)).to(dev),
        v=torch.from_numpy(v.astype(numpy.float32)).to(dev),
    )
    return sc, state


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [48, 128])
def test_ghost_halo_kernels_match_wrapped_plain(cuda, capacity):
    """The single-tier entry points with ``wrap_axes``: kernels on the
    ghost halo against the plain passes on the wrapped neighbour table
    with minimum-image separations."""
    sc, state = _periodic_box(cuda)
    grid, params = sc.grid._replace(capacity=capacity), sc.params
    wrap = (True, True, True)
    cells = build_cells(state.x, grid)
    assert int(cells.overflow) == 0
    soa = scatter_to_cells_soa(torch.cat([state.x, state.v], 1), cells, grid)
    m = cells.mask[: grid.n_cells]
    live = m.cpu().numpy()
    ops.reset_launch_counts()
    got = ops.density(soa[:3], m, grid, params, wrap_axes=wrap)
    want = ops.density_plain(soa[:3], m, grid, params, wrap_axes=wrap)
    _scaled_close(got, want, live, 1e-5, 1e-6)
    # a periodic lattice has no wall deficit (walls would halve rho there)
    assert float(want[m].min()) > 0.8 * float(want[m].max())
    tier = (soa[:3], soa[3:], *_finish(want, m, params), m)
    got = ops.accel(*tier, grid, params, wrap_axes=wrap)
    want = ops.accel_plain(*tier, grid, params, wrap_axes=wrap)
    for col in range(3):
        _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
    got = ops.accel_drho(*tier, grid, params, wrap_axes=wrap)
    want = ops.accel_drho_plain(*tier, grid, params, wrap_axes=wrap)
    for col in range(4):
        _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
    role = "wide" if capacity > 64 else "self"
    assert _launched() == {
        "density_" + role: 1, "accel_" + role: 1, "accel_drho_" + role: 1
    }


@pytest.mark.cuda
def test_ghost_halo_spill_kernels_match_wrapped_plain(cuda):
    """The two-tier entry points with ``wrap_axes`` at K = 16 (the spill
    tier is occupied), ghost halo against wrapped table."""
    sc, state = _periodic_box(cuda)
    k = 16
    grid, params = sc.grid._replace(capacity=k), sc.params
    wrap = (True, True, True)
    cells, sp = build_cells_spill(state.x, grid, k)
    assert int(cells.overflow) == 0 and bool(sp.mask.any())
    xv = torch.cat([state.x, state.v], 1)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    c = grid.n_cells
    ma, mb = cells.mask[:c], sp.mask[:c]
    live = (ma.cpu().numpy(), mb.cpu().numpy())
    args = (a[:3], ma, b[:3], mb, grid, params)
    got = ops.density_spill(*args, wrap_axes=wrap)
    want = ops.density_spill_plain(*args, wrap_axes=wrap)
    for t in range(2):
        _scaled_close(got[t], want[t], live[t], 1e-5, 1e-6)
    ta = (a[:3], a[3:], *_finish(want[0], ma, params), ma)
    tb = (b[:3], b[3:], *_finish(want[1], mb, params), mb)
    for fn, plain, cols in (
        (ops.accel_spill, ops.accel_spill_plain, 3),
        (ops.accel_drho_spill, ops.accel_drho_spill_plain, 4),
    ):
        got = fn(*ta, *tb, grid, params, wrap_axes=wrap)
        want = plain(*ta, *tb, grid, params, wrap_axes=wrap)
        for t in range(2):
            for col in range(cols):
                _scaled_close(got[t][..., col], want[t][..., col], live[t],
                              1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize(
    "scenario, capacity", [("dam_break", 128), ("periodic", 128),
                           ("periodic", 16)],
    ids=["wide", "periodic_wide", "periodic_spill"],
)
def test_single_tier_and_periodic_kernel_steps_match_plain_steps(
    cuda, scenario, capacity, density_mode
):
    """Three steps of the "auto" kernel step (the wide single tier at K =
    128; the periodic box on the wide layout and on the two-tier layout
    at K = 16 + 16) against the single-tier plain step, which takes the
    wrapped table and the minimum image where the kernels take the ghost
    halo.  The change of the carried density over the steps is held as in
    test_kernel_continuity_step_matches_plain_step."""
    periodic = scenario == "periodic"
    if periodic:
        sc, state = _periodic_box(cuda)
        grid, params = sc.grid._replace(capacity=capacity), sc.params
    else:
        db = dam_break(n_side=10, capacity=capacity, device=cuda)
        rng = numpy.random.default_rng(5)
        dv = 0.1 * rng.standard_normal(tuple(db.state.v.shape))
        state = db.state._replace(
            v=torch.from_numpy(dv.astype(numpy.float32)).to(cuda))
        grid, params = db.grid, db.params
    kw = {"periodic": periodic, "density_mode": density_mode, "device": cuda}
    step_k = make_step_fn(grid, params, **kw)
    spill = capacity <= 64
    assert step_k.resolved == {
        "use_kernels": True, "spill": spill, "density_mode": density_mode
    }
    plain_grid = grid._replace(capacity=2 * capacity) if spill else grid
    step_p = make_step_fn(plain_grid, params, use_kernels=False, spill=False,
                          **kw)
    if density_mode == "continuity":
        state = init_density(state, plain_grid, params, periodic=periodic,
                             device=cuda)
    ops.reset_launch_counts()
    sk = sp = state
    for _ in range(3):
        sk, (rho_k, _, ov_k) = step_k(sk)
        sp, (rho_p, _, ov_p) = step_p(sp)
        assert int(ov_k) == int(ov_p) == 0
    family = "accel_drho" if density_mode == "continuity" else "accel"
    want = ({family + "_self": 6, family + "_cross": 6} if spill
            else {family + "_wide": 3})
    if density_mode == "summation":
        want.update({"density_self": 6, "density_cross": 6} if spill
                    else {"density_wide": 3})
    assert _launched() == want
    numpy.testing.assert_allclose(
        sk.x.cpu().numpy(), sp.x.cpu().numpy(), rtol=1e-5, atol=1e-6
    )
    if density_mode == "summation":
        _scaled_close(rho_k, rho_p, numpy.ones(rho_p.shape, bool), 1e-5, 1e-6)
        return
    d_k = (sk.rho - state.rho).cpu().numpy()
    d_p = (sp.rho - state.rho).cpu().numpy()
    scale = float(numpy.abs(d_p).max())
    assert scale > 100 * 2.5e-4, "the steps must change the carried density"
    numpy.testing.assert_allclose(
        d_k / scale, d_p / scale, rtol=1e-4, atol=1e-5 + 3 * 2.5e-4 / scale
    )


# --------------------------------------------------------------------------
# the pair passes the reference runs in jnp: XSPH (rides the momentum
# kernel), the Akinci surface normals and force, the energy rate
# --------------------------------------------------------------------------

GAMMA = 0.05  # surface-tension strength
XSPH = 0.5


def _normals(a, b, grid, params, kernel):
    """The complete plain normals of both tiers (``AA + AB``, ``BB +
    BA``), as the force pass takes them."""
    def n(cen, nbr):
        return ops.st_normals_pairs_plain(cen[0], cen[4], nbr[0], nbr[2],
                                          nbr[4], grid, params, kernel)

    return n(a, a) + n(a, b), n(b, b) + n(b, a)


def _hold_option_roles(grid, params, tiers, normals, kernel, tile=None,
                       roles=None):
    """Every new role on the tiers ``tiers`` (each ``(x, v, rho, p,
    mask)``, ``normals`` theirs) against its plain version, each output
    plane scaled by its max at rtol 1e-4, atol 1e-5; dead centre slots are
    exactly 0.  The XSPH instances' acceleration (and drho/dt) planes must
    be bit-identical to those of the instances without XSPH.  ``roles``:
    the (centre, neighbour) index pairs (default: every pair)."""
    n_t = len(tiers)
    roles = roles or [(i, j) for i in range(n_t) for j in range(n_t)]
    for i, j in roles:
        c, nb, cross = tiers[i], tiers[j], i != j
        live = c[4].cpu().numpy()
        if not live.any():
            continue
        kw = {"kernel": kernel, "cross": cross, "tile": tile}
        cases = [
            ("accel_xsph", ops.accel_pairs(*c, *nb, grid, params, xsph=True, **kw),
             ops.accel_pairs_plain(*c, *nb, grid, params, kernel=kernel,
                                   xsph=True),
             ops.accel_pairs(*c, *nb, grid, params, **kw)),
            ("accel_drho_xsph",
             ops.accel_drho_pairs(*c, *nb, grid, params, xsph=True, **kw),
             ops.accel_drho_pairs_plain(*c, *nb, grid, params, kernel=kernel,
                                        xsph=True),
             ops.accel_drho_pairs(*c, *nb, grid, params, **kw)),
            ("st_normals",
             ops.st_normals_pairs(c[0], c[4], nb[0], nb[2], nb[4], grid,
                                  params, **kw),
             ops.st_normals_pairs_plain(c[0], c[4], nb[0], nb[2], nb[4], grid,
                                        params, kernel), None),
            ("st_force",
             ops.st_force_pairs(c[0], normals[i], c[2], c[4], nb[0],
                                normals[j], nb[2], nb[4], grid, params, GAMMA,
                                **kw),
             ops.st_force_pairs_plain(c[0], normals[i], c[2], c[4], nb[0],
                                      normals[j], nb[2], nb[4], grid, params,
                                      GAMMA, kernel), None),
            ("energy", ops.energy_pairs(*c, *nb, grid, params, **kw),
             ops.energy_pairs_plain(*c, *nb, grid, params, kernel), None),
        ]
        for name, got, want, base in cases:
            tag = "%s %d<-%d %s" % (name, i, j, kernel.__name__)
            planes = [(got, want)] if got.dim() == 2 else list(zip(got, want))
            for g, w in planes:
                assert not bool(g[~c[4]].any()), tag + ": dead centre slots"
                if not bool(w[c[4]].any()):
                    assert not bool(g.any()), tag
                    continue
                _scaled_close(g, w, live, 1e-4, 1e-5)
            if base is not None:
                assert torch.equal(got[: base.shape[0]], base), (
                    tag + ": the XSPH instance changed the other planes")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("kernel", ["WendlandC2", "CubicSpline"])
def test_option_kernels_match_plain_on_two_tiers(cuda, kernel, k):
    """The new roles at K = 24 with the spill tier occupied, and at K =
    32: self (A <- A, B <- B) and cross (A <- B, B <- A) wherever the
    centre tier holds a particle, with the launch counts; the normals
    each force launch takes are complete (both tiers)."""
    kernel = getattr(port_kernels, kernel)
    grid, params, a, b = _spill_tiers(cuda, k=k)
    normals = _normals(a, b, grid, params, kernel)
    ops.reset_launch_counts()
    _hold_option_roles(grid, params, (a, b), normals, kernel)
    torch.cuda.synchronize()
    n = sum(bool(t[4].any()) for t in (a, b))  # tiers with a centre
    want = {}
    # the instances without XSPH are launched once a role for the bit check
    for family in ("accel_xsph", "accel_drho_xsph", "st_normals", "st_force",
                   "energy", "accel", "accel_drho"):
        want.update({family + "_self": n, family + "_cross": n})
    assert _launched() == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k128", "k1024", "dense"])
def test_option_kernels_match_plain_past_64_slots(cuda, case):
    """The new roles' wide instances: a cloud at K = 128 with arbitrary
    masks, K = 1024 on a small grid, and a cloud whose densest ranges are
    staged in three or more pieces at T = 1, at the wrapper's T and forced
    ones."""
    if case == "k128":
        grid, params, tier = _cloud_tier(cuda, 128, True)
        tiles = (None, 3)
    else:
        grid, params, tier, _ = _wide_tile_case(cuda, case)
        tiles = (None, 1, 16)
    live = tier[4].cpu().numpy()
    assert live.sum() > 0 and grid.capacity > ops.MAX_CAPACITY
    if case == "dense":
        cap = ops.tile_shared_bytes("st_force", grid, params, 1) // 32
        assert _most_live_in_a_range(live, grid.dims, 1) > 2 * cap
    ops.reset_launch_counts()
    for kernel in (port_kernels.WendlandC2, port_kernels.CubicSpline):
        normals = ops.st_normals_pairs_plain(tier[0], tier[4], tier[0],
                                             tier[2], tier[4], grid, params,
                                             kernel)
        for tile in tiles:
            _hold_option_roles(grid, params, (tier,), (normals,), kernel,
                               tile=tile)
    torch.cuda.synchronize()
    runs = 2 * len(tiles)
    want = {f + "_wide": runs for f in ("accel_xsph", "accel_drho_xsph",
                                        "st_normals", "st_force", "energy")}
    want.update({"accel_wide": runs, "accel_drho_wide": runs})
    assert _launched() == want


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [16, 48, 128])
def test_option_ghost_halo_matches_wrapped_plain(cuda, capacity):
    """The periodic route of the new passes (ghost halo; the normals
    selected back to the interior rows before the force pass expands them
    again) against the plain versions' wrapped table: the single tier at
    K = 48 and 128, both tiers at K = 16 (spill tier occupied)."""
    sc, state = _periodic_box(cuda)
    grid, params = sc.grid._replace(capacity=capacity), sc.params
    wrap = (True, True, True)
    xv = torch.cat([state.x, state.v], 1)
    c = grid.n_cells
    ops.reset_launch_counts()
    if capacity == 16:
        cells, sp = build_cells_spill(state.x, grid, capacity)
        assert int(cells.overflow) == 0 and bool(sp.mask.any())
        a = scatter_to_cells_soa(xv, cells, grid)
        b = scatter_to_cells_soa(xv, cells, grid, slot_base=capacity,
                                 capacity=capacity)
        ma, mb = cells.mask[:c], sp.mask[:c]
        rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, params,
                                      wrap_axes=wrap)
        ta = (a[:3], a[3:], *_finish(rho[0], ma, params), ma)
        tb = (b[:3], b[3:], *_finish(rho[1], mb, params), mb)
        st = (ta[0], ta[2], ma, tb[0], tb[2], mb, grid, params, GAMMA)
        pairs = [
            (ops.accel_spill(*ta, *tb, grid, params, wrap_axes=wrap, xsph=True),
             ops.accel_spill_plain(*ta, *tb, grid, params, wrap_axes=wrap,
                                   xsph=True)),
            (ops.accel_drho_spill(*ta, *tb, grid, params, wrap_axes=wrap,
                                  xsph=True),
             ops.accel_drho_spill_plain(*ta, *tb, grid, params,
                                        wrap_axes=wrap, xsph=True)),
            (ops.surface_tension_spill(*st, wrap_axes=wrap),
             ops.surface_tension_spill_plain(*st, wrap_axes=wrap)),
        ]
        lives = (ma.cpu().numpy(), mb.cpu().numpy())
        for got, want in pairs:
            for t in range(2):
                for col in range(want[t].shape[-1]):
                    _scaled_close(got[t][..., col], want[t][..., col],
                                  lives[t], 1e-4, 1e-5)
        want_counts = {f + r: 2 for f in ("accel_xsph", "accel_drho_xsph",
                                          "st_normals", "st_force")
                       for r in ("_self", "_cross")}
    else:
        cells = build_cells(state.x, grid)
        assert int(cells.overflow) == 0
        soa = scatter_to_cells_soa(xv, cells, grid)
        m = cells.mask[:c]
        rho = ops.density_plain(soa[:3], m, grid, params, wrap_axes=wrap)
        t = (soa[:3], soa[3:], *_finish(rho, m, params), m)
        st = (t[0], t[2], m, grid, params, GAMMA)
        pairs = [
            (ops.accel(*t, grid, params, wrap_axes=wrap, xsph=True),
             ops.accel_plain(*t, grid, params, wrap_axes=wrap, xsph=True)),
            (ops.accel_drho(*t, grid, params, wrap_axes=wrap, xsph=True),
             ops.accel_drho_plain(*t, grid, params, wrap_axes=wrap, xsph=True)),
            (ops.surface_tension(*st, wrap_axes=wrap),
             ops.surface_tension_plain(*st, wrap_axes=wrap)),
            (ops.energy(*t, grid, params, wrap_axes=wrap)[None],
             ops.energy_plain(*t, grid, params, wrap_axes=wrap)[None]),
        ]
        live = m.cpu().numpy()
        for got, want in pairs:
            for col in range(want.shape[0]):
                _scaled_close(got[col], want[col], live, 1e-4, 1e-5)
        role = "_wide" if capacity > 64 else "_self"
        want_counts = {f + role: 1 for f in ("accel_xsph", "accel_drho_xsph",
                                             "st_normals", "st_force",
                                             "energy")}
    torch.cuda.synchronize()
    assert _launched() == want_counts


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize(
    "scenario, capacity", [("dam_break", 24), ("dam_break", 128),
                           ("periodic", 16)],
    ids=["spill", "wide", "periodic_spill"],
)
def test_kernel_steps_with_options_match_plain_steps(
    cuda, scenario, capacity, density_mode
):
    """Three kernel steps with ``xsph=0.5`` and ``surface_tension=0.05``
    against the single-tier plain step (twice the capacity for the
    two-tier layout, slot-identical), with the exact launch counts: on
    the two-tier layout XSPH adds no launch and surface tension 4 normals
    and 4 force launches a step, on the single tier 1 + 1."""
    periodic = scenario == "periodic"
    if periodic:
        sc, state = _periodic_box(cuda)
        grid, params = sc.grid._replace(capacity=capacity), sc.params
    else:
        db = dam_break(n_side=10, capacity=capacity, device=cuda)
        rng = numpy.random.default_rng(5)
        dv = 0.1 * rng.standard_normal(tuple(db.state.v.shape))
        state = db.state._replace(
            v=torch.from_numpy(dv.astype(numpy.float32)).to(cuda))
        grid, params = db.grid, db.params
    kw = {"periodic": periodic, "density_mode": density_mode, "device": cuda,
          "xsph": XSPH, "surface_tension": GAMMA}
    step_k = make_step_fn(grid, params, **kw)
    spill = capacity <= 64
    assert step_k.resolved == {
        "use_kernels": True, "spill": spill, "density_mode": density_mode
    }
    plain_grid = grid._replace(capacity=2 * capacity) if spill else grid
    step_p = make_step_fn(plain_grid, params, use_kernels=False, spill=False,
                          **kw)
    if density_mode == "continuity":
        state = init_density(state, plain_grid, params, periodic=periodic,
                             device=cuda)
    ops.reset_launch_counts()
    sk = sp = state
    for _ in range(3):
        sk, (rho_k, _, ov_k) = step_k(sk)
        sp, (rho_p, _, ov_p) = step_p(sp)
        assert int(ov_k) == int(ov_p) == 0
    torch.cuda.synchronize()
    family = ("accel_drho_xsph" if density_mode == "continuity"
              else "accel_xsph")
    families = [family, "st_normals", "st_force"]
    if density_mode == "summation":
        families.append("density")
    want = ({f + r: 6 for f in families for r in ("_self", "_cross")}
            if spill else {f + "_wide": 3 for f in families})
    assert _launched() == want
    numpy.testing.assert_allclose(
        sk.x.cpu().numpy(), sp.x.cpu().numpy(), rtol=1e-5, atol=1e-6)
    everything = numpy.ones(tuple(sp.v.shape), bool)
    _scaled_close(sk.v, sp.v, everything, 1e-4, 1e-5)
    if density_mode == "summation":
        _scaled_close(rho_k, rho_p, everything[:, 0], 1e-5, 1e-6)
    else:
        numpy.testing.assert_allclose(
            sk.rho.cpu().numpy(), sp.rho.cpu().numpy(), rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [48, 128])
@pytest.mark.parametrize("periodic", [False, True], ids=["closed", "periodic"])
def test_energy_rate_on_the_card_matches_the_plain_pass(cuda, capacity,
                                                        periodic):
    sc, state = _periodic_box(cuda)
    grid, params = sc.grid._replace(capacity=capacity), sc.params
    ops.reset_launch_counts()
    got = energy_rate(state, grid, params, periodic=periodic)
    torch.cuda.synchronize()
    role = "_wide" if capacity > 64 else "_self"
    assert _launched() == {"density" + role: 1, "energy" + role: 1}
    want = energy_rate(SPHState(x=state.x.cpu(), v=state.v.cpu()), grid,
                       params, periodic=periodic, device="cpu")
    _scaled_close(got, want, numpy.ones(tuple(want.shape), bool), 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("capacity", [24, 128], ids=["spill", "wide"])
def test_adaptive_kernel_step_matches_fixed_and_never_syncs(
        cuda, capacity, density_mode):
    """On the card the adaptive step at ``dt == params.dt`` is the fixed
    step bit for bit with the same launches, and a ``run_adaptive``
    rollout makes no host sync (``set_sync_debug_mode("error")``)."""
    from tpgsd_torch.sph import make_adaptive_step_fn, run_adaptive

    db = dam_break(n_side=10, capacity=capacity, device=cuda)
    kw = {"density_mode": density_mode, "device": cuda}
    step_f = make_step_fn(db.grid, db.params, **kw)
    step_a = make_adaptive_step_fn(db.grid, db.params, **kw)
    assert step_a.resolved == step_f.resolved
    assert step_a.resolved["spill"] == (capacity == 24)
    state = db.state
    if density_mode == "continuity":
        state = init_density(state, db.grid, db.params, device=cuda)
    dt = torch.full((), db.params.dt, device=cuda)
    counts = []
    s_f = s_a = state
    for which in ("fixed", "adaptive"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for _ in range(3):
            if which == "fixed":
                s_f, aux_f = step_f(s_f)
            else:
                s_a, aux_a, _ = step_a(s_a, dt)
        torch.cuda.synchronize()
        counts.append(_launched())
    assert counts[0] == counts[1] and counts[0]
    assert torch.equal(s_a.x, s_f.x) and torch.equal(s_a.v, s_f.v)
    assert torch.equal(aux_a[0], aux_f[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, dt_next, t = run_adaptive(step_a, state, db.params.dt, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(s.x).all()
    assert 0.0 < float(dt_next) <= db.params.dt
    assert 0.0 < float(t) <= 5 * db.params.dt


@pytest.mark.cuda
def test_on_device_lattice_and_resume_on_the_card(cuda, tmp_path):
    """``dam_break(on_device=True)`` on the card against the host lattice,
    and a ``resume`` onto the card of the frame it dumped."""
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph import resume

    host = dam_break(n_side=20, capacity="auto", device=cuda)
    card = dam_break(n_side=20, capacity="auto", device=cuda, on_device=True)
    assert (card.n, card.grid, card.params) == (host.n, host.grid, host.params)
    assert torch.allclose(card.state.x, host.state.x, rtol=0, atol=1e-6)
    path = tmp_path / "lattice.gsd"
    with ShardedFrameWriter(path, comm=SingleComm()) as writer:
        writer.write_frame({"particles/position": card.state.x,
                            "particles/velocity": card.state.v}, step=4)
    state, step, writer, _ = resume(path, comm=SingleComm())
    writer.close()
    assert step == 4 and state.x.is_cuda
    assert torch.equal(state.x, card.state.x)


def _slab_state(dev, capacity, density_mode, seed=3):
    """The jittered dam break (``n_side=10``, 9x4x4 cells, 3 slabs) with
    N(0, 1) velocities at ``capacity`` on ``dev`` (continuity: its
    summation density seeded by a slab step)."""
    from tpgsd_torch.sph import slab_init_density

    db = dam_break(n_side=10, capacity=capacity, device="cpu")
    rng = numpy.random.default_rng(seed)
    x = db.state.x.numpy()
    x = x + (0.05 * db.params.h / 1.3) * rng.standard_normal(x.shape)
    v = rng.standard_normal(x.shape)
    state = SPHState(x=torch.from_numpy(x.astype(numpy.float32)).to(dev),
                     v=torch.from_numpy(v.astype(numpy.float32)).to(dev))
    if density_mode == "continuity":
        state = slab_init_density(state, db.grid, db.params, 3, device=dev)
    return db, state


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("capacity", [24, 128], ids=["spill", "wide"])
def test_slab_kernel_step_matches_slab_plain_step(cuda, capacity,
                                                  density_mode):
    """The slab step through the kernels against the slab step through the
    plain passes on the card, on every slab's extended grid (its empty
    virtual planes at the domain's ends included): positions rtol 1e-5,
    atol 1e-6, density rtol 1e-5; the kernel launches are counted per
    slab."""
    from tpgsd_torch.sph import make_slab_step_fn

    db, state = _slab_state(cuda, capacity, density_mode)
    spill = capacity == 24
    kw = {"density_mode": density_mode, "device": cuda}
    step_k = make_slab_step_fn(db.grid, db.params, 3, **kw)
    step_p = make_slab_step_fn(db.grid, db.params, 3, use_kernels=False,
                               spill=spill, **kw)
    assert step_k.resolved == {"use_kernels": True, "spill": spill,
                               "density_mode": density_mode}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sk, (rk, _pk, ok, wk) = step_k(state)
    torch.cuda.synchronize()
    families = (("accel_drho",) if density_mode == "continuity"
                else ("density", "accel"))
    roles = ("self", "cross") if spill else ("wide",)
    want = {"%s_%s" % (f, r): 3 * (2 if spill else 1)
            for f in families for r in roles}
    assert _launched() == want
    sp, (rp, _pp, op, wp) = step_p(state)
    assert int(ok) == int(op) and int(wk) == int(wp) == 0
    torch.testing.assert_close(sk.x, sp.x, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
def test_silent_slab_steps_never_sync(cuda, density_mode):
    """Silent slab steps make no host sync: the slab offsets are host
    integers and every per-slab scalar stays on the card."""
    from tpgsd_torch.sph import make_slab_step_fn

    db, state = _slab_state(cuda, 24, density_mode)
    step = make_slab_step_fn(db.grid, db.params, 3, device=cuda,
                             density_mode=density_mode)
    state, _ = step(state)  # the kernels are built and loaded here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            state, aux = step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(aux[3]) == 0 and bool(torch.isfinite(state.x).all())


@pytest.mark.cuda
def test_emitted_frame_equals_the_post_step_state_on_the_card(cuda, tmp_path):
    """Windows copied on the side stream into a ring smaller than the slab
    count (``RING`` = 2 buffers for 3 slabs, so buffers are reused)
    reassemble the post-step state bit for bit; the silent steps between
    stay in lockstep."""
    import tpgsd_torch.pypgsd
    from tpgsd_torch.io_runtime import SlabDumpChannel
    from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
    from tpgsd_torch.sph import make_slab_step_fn

    db, state = _slab_state(cuda, 24, "continuity")
    path = str(tmp_path / "slab.gsd")
    keys = ("position", "velocity", "density", "pressure")
    chan = SlabDumpChannel(ShardedFrameWriter(path, comm=SingleComm()),
                           n=db.n, n_slabs=3, keys=keys)
    kw = {"density_mode": "continuity", "device": cuda}
    step = make_slab_step_fn(db.grid, db.params, 3, slab_emit=chan.slab_emit,
                             **kw)
    plain = make_slab_step_fn(db.grid, db.params, 3, **kw)
    s, ref, want = state, state, []
    for i in range(4):
        s, _ = step(s, chan.dump(i) if i % 2 else chan.no_dump())
        ref, (rho, p, _o, w) = plain(ref)
        assert int(w) == 0
        if i % 2:
            want.append((ref, rho, p))
    chan.close()
    assert torch.equal(s.x, ref.x) and torch.equal(s.v, ref.v)
    assert chan.d2h_bytes == 2 * 3 * (db.n * (8 * 4 + 4) + 16)
    with open(path, "rb") as fh:
        assert tpgsd_torch.pypgsd.verify(fh, deep=True)["ok"]
    with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 2
        for frame, (st, rho, p) in enumerate(want):
            for name, t in (("position", st.x), ("velocity", st.v),
                            ("density", rho), ("pressure", p)):
                assert numpy.array_equal(
                    f.read_chunk(frame, "particles/" + name), t.cpu().numpy())


def _by_pid(dist, field, n):
    """A decomposed state's ``field`` as one ``[n, ...]`` tensor in pid
    order."""
    pid = torch.cat(dist.pid).long()
    vals = torch.cat(getattr(dist, field))
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    out[pid[pid >= 0]] = vals[pid >= 0]
    return out


def _decomposed_pair(dev, layout, density_mode, n_shards=2, **kw):
    """A dam break whose 80 x cells divide by ``n_shards`` on a mesh of
    ``n_shards`` shards of ``dev``: the "auto" decomposed kernel step and
    the plain decomposed step (on the kernel step's layout), and the state
    with seeded N(0, 1) velocities."""
    from tpgsd_torch.parallel import make_mesh
    from tpgsd_torch.sph import distribute_state, make_distributed_step_fn

    db = dam_break(n_side=13, box=(4.0, 0.5, 0.5), fill=(1.0, 1.0, 0.5),
                   capacity=16 if layout == "spill" else 96, device=dev)
    assert db.grid.dims[0] % n_shards == 0, db.grid.dims
    rng = numpy.random.default_rng(9)
    v = torch.from_numpy(
        rng.standard_normal(tuple(db.state.v.shape)).astype(numpy.float32))
    state = db.state._replace(v=v.to(dev))
    if density_mode == "continuity":
        state = init_density(state, db.grid, db.params, device=dev)
    mesh = make_mesh(devices=[dev] * n_shards)
    dist, cap = distribute_state(state, db.grid, mesh)
    step_k = make_distributed_step_fn(db.grid, db.params, mesh, capacity=cap,
                                      density_mode=density_mode, **kw)
    step_p = make_distributed_step_fn(db.grid, db.params, mesh, capacity=cap,
                                      density_mode=density_mode,
                                      use_kernels=False,
                                      spill=layout == "spill", **kw)
    assert step_k.resolved == {"use_kernels": True,
                               "spill": layout == "spill",
                               "density_mode": density_mode}
    return db, mesh, dist, cap, step_k, step_p


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("layout", ["spill", "wide"])
def test_decomposed_kernel_step_matches_plain(cuda, layout, density_mode):
    """Three decomposed kernel steps on 4 shards of one card, each against
    the plain decomposed step from the same state: the same pids in every
    slot, positions rtol 1e-5, atol 1e-6, summation density rtol 1e-5,
    atol 1e-6 (scaled), velocities rtol 1e-4, atol 1e-5 (scaled), and the
    step's change of each particle's velocity within 1e-5 of its largest
    change plus 1e-4 of its own and the rounding of v (one step moves x
    by only dt^2 a, so the position check alone passes any acceleration);
    the launches of a step are 4 times a global step's."""
    db, mesh, dist, _cap, step_k, step_p = _decomposed_pair(
        cuda, layout, density_mode, n_shards=4)
    for _ in range(3):
        ops.reset_launch_counts()
        sk, ak = step_k(dist)
        launched = _launched()
        sp, ap = step_p(dist)
        for a, b in zip(sk.pid, sp.pid):
            assert torch.equal(a, b)
        live = torch.cat([p >= 0 for p in sk.pid]).cpu().numpy()
        numpy.testing.assert_allclose(torch.cat(sk.x).cpu().numpy(),
                                      torch.cat(sp.x).cpu().numpy(),
                                      rtol=1e-5, atol=1e-6)
        if density_mode == "summation":
            _scaled_close(torch.cat(ak.rho), torch.cat(ap.rho), live, 1e-5,
                          1e-6)
        else:
            numpy.testing.assert_allclose(torch.cat(sk.rho).cpu().numpy(),
                                          torch.cat(sp.rho).cpu().numpy(),
                                          rtol=1e-4, atol=1e-2)
        _scaled_close(torch.cat(sk.v), torch.cat(sp.v), live, 1e-4, 1e-5)
        v0, vk, vp = (_by_pid(st, "v", db.n) for st in (dist, sk, sp))
        dv = vp - v0
        tol = 1e-5 * dv.abs().max() + 1e-4 * dv.abs() + 2.0 ** -22 * vp.abs()
        assert bool(((vk - vp).abs() <= tol).all()), float(
            ((vk - vp).abs() / dv.abs().max()).max())
        dist = sk
    family = "accel_drho" if density_mode == "continuity" else "accel"
    want = ({family + "_self": 8, family + "_cross": 8} if layout == "spill"
            else {family + "_wide": 4})
    if density_mode == "summation":
        want.update({"density_self": 8, "density_cross": 8}
                    if layout == "spill" else {"density_wide": 4})
    assert launched == want


@pytest.mark.cuda
def test_decomposed_adaptive_rollout_makes_no_host_sync(cuda):
    """A 10-step adaptive rollout of the decomposed step on 2 shards of
    one card under ``set_sync_debug_mode("error")``."""
    from tpgsd_torch.sph import (
        collect_state,
        make_adaptive_distributed_step_fn,
        run_adaptive,
    )

    db, mesh, dist, cap, _k, _p = _decomposed_pair(cuda, "spill",
                                                    "summation")
    step = make_adaptive_distributed_step_fn(db.grid, db.params, mesh,
                                             capacity=cap)
    step(dist, torch.tensor(db.params.dt, device=cuda))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dt, t = run_adaptive(step, dist, db.params.dt, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert 0.0 < float(dt) <= float(numpy.float32(db.params.dt))
    assert float(t) > 0.0
    got = collect_state(out, db.n)
    assert numpy.isfinite(got.x).all()


def _block_pair(dev, form, layout, density_mode, **kw):
    """The 4,096-particle cube (6 x 6 x 6 cells, every block populated) on
    the (2, 2) or (2, 2, 2) block mesh of ``dev``: the "auto" block kernel
    step, the plain block step on its layout, and the state with seeded
    N(0, 1) velocities."""
    from tpgsd_torch.parallel import make_mesh2d, make_mesh3d
    from tpgsd_torch.sph import (
        distribute_state_2d,
        distribute_state_3d,
        make_distributed2d_step_fn,
        make_distributed3d_step_fn,
    )

    db = dam_break(n_side=16, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0),
                   capacity=16 if layout == "spill" else 96, device=dev)
    assert db.grid.dims == (6, 6, 6), db.grid.dims
    rng = numpy.random.default_rng(11)
    v = torch.from_numpy(
        rng.standard_normal(tuple(db.state.v.shape)).astype(numpy.float32))
    state = db.state._replace(v=v.to(dev))
    if density_mode == "continuity":
        state = init_density(state, db.grid, db.params, device=dev)
    if form == "2d":
        mesh = make_mesh2d(shape=(2, 2), devices=[dev] * 4)
        dist, cap = distribute_state_2d(state, db.grid, mesh)
        make = make_distributed2d_step_fn
    else:
        mesh = make_mesh3d(shape=(2, 2, 2), devices=[dev] * 8)
        dist, cap = distribute_state_3d(state, db.grid, mesh)
        make = make_distributed3d_step_fn
    step_k = make(db.grid, db.params, mesh, capacity=cap,
                  density_mode=density_mode, **kw)
    step_p = make(db.grid, db.params, mesh, capacity=cap,
                  density_mode=density_mode, use_kernels=False,
                  spill=layout == "spill", **kw)
    assert step_k.resolved == {"use_kernels": True,
                               "spill": layout == "spill",
                               "density_mode": density_mode}
    return db, mesh, dist, cap, step_k, step_p


@pytest.mark.cuda
@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("layout", ["spill", "wide"])
@pytest.mark.parametrize("form", ["2d", "3d"])
def test_block_kernel_step_matches_plain(cuda, form, layout, density_mode):
    """Three 2-D or 3-D block kernel steps on one card, each against the
    plain block step from the same state, at the tolerances of
    test_decomposed_kernel_step_matches_plain (the step's change of v
    included); the launches of a step are the shards times a global
    step's."""
    db, mesh, dist, _cap, step_k, step_p = _block_pair(cuda, form, layout,
                                                       density_mode)
    for _ in range(3):
        ops.reset_launch_counts()
        sk, ak = step_k(dist)
        launched = _launched()
        sp, ap = step_p(dist)
        for a, b in zip(sk.pid, sp.pid):
            assert torch.equal(a, b)
        live = torch.cat([p >= 0 for p in sk.pid]).cpu().numpy()
        numpy.testing.assert_allclose(torch.cat(sk.x).cpu().numpy(),
                                      torch.cat(sp.x).cpu().numpy(),
                                      rtol=1e-5, atol=1e-6)
        if density_mode == "summation":
            _scaled_close(torch.cat(ak.rho), torch.cat(ap.rho), live, 1e-5,
                          1e-6)
        else:
            numpy.testing.assert_allclose(torch.cat(sk.rho).cpu().numpy(),
                                          torch.cat(sp.rho).cpu().numpy(),
                                          rtol=1e-4, atol=1e-2)
        _scaled_close(torch.cat(sk.v), torch.cat(sp.v), live, 1e-4, 1e-5)
        v0, vk, vp = (_by_pid(st, "v", db.n) for st in (dist, sk, sp))
        dv = vp - v0
        tol = 1e-5 * dv.abs().max() + 1e-4 * dv.abs() + 2.0 ** -22 * vp.abs()
        assert bool(((vk - vp).abs() <= tol).all()), float(
            ((vk - vp).abs() / dv.abs().max()).max())
        dist = sk
    n = mesh.size
    family = "accel_drho" if density_mode == "continuity" else "accel"
    want = ({family + "_self": 2 * n, family + "_cross": 2 * n}
            if layout == "spill" else {family + "_wide": n})
    if density_mode == "summation":
        want.update({"density_self": 2 * n, "density_cross": 2 * n}
                    if layout == "spill" else {"density_wide": n})
    assert launched == want


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["2d", "3d"])
def test_block_adaptive_rollout_makes_no_host_sync(cuda, form):
    """A 10-step adaptive rollout of the 2-D or 3-D block step on one card
    under ``set_sync_debug_mode("error")``."""
    from tpgsd_torch.sph import (
        collect_state,
        make_adaptive_distributed2d_step_fn,
        make_adaptive_distributed3d_step_fn,
        run_adaptive,
    )

    db, mesh, dist, cap, _k, _p = _block_pair(cuda, form, "spill",
                                              "summation")
    make = (make_adaptive_distributed2d_step_fn if form == "2d"
            else make_adaptive_distributed3d_step_fn)
    step = make(db.grid, db.params, mesh, capacity=cap)
    step(dist, torch.tensor(db.params.dt, device=cuda))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dt, t = run_adaptive(step, dist, db.params.dt, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert 0.0 < float(dt) <= float(numpy.float32(db.params.dt))
    assert float(t) > 0.0
    got = collect_state(out, db.n)
    assert numpy.isfinite(got.x).all()


@pytest.mark.cuda
def test_sorted_runs_on_the_card_equal_the_cpu(cuda):
    """The cell build's runs at the 1M dam break's shape (1,003,104 ids
    over 82 x 41 x 41 cells, two thirds of them empty): the card's
    ``order``, ``slot`` and ``starts`` equal the CPU's."""
    c = 82 * 41 * 41
    g = torch.Generator().manual_seed(18)
    cid = torch.randint(0, c // 3, (1_003_104,), generator=g)
    want = sorted_runs(cid, c)
    got = sorted_runs(cid.to(cuda), c)
    for name, w, o in zip(("order", "cid_s", "slot", "starts"), want, got):
        assert o.dtype == torch.int64, name
        assert torch.equal(o.cpu(), w), name


#: the pair kernels' launch-count keys (the benchmark compares every
#: nonzero one with a configuration's ``launches_per_step``)
PAIR_LAUNCH_KEYS = {
    "%s_%s" % (family, role)
    for family in ("density", "accel", "accel_drho", "accel_xsph",
                   "accel_drho_xsph", "st_normals", "st_force", "energy")
    for role in ("self", "cross", "wide")
}


def _on_cpu(a):
    """``a`` with every tensor (in lists, tuples and NamedTuples) copied to
    the CPU."""
    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_on_cpu(v) for v in a))
    if isinstance(a, (list, tuple)):
        return type(a)(_on_cpu(v) for v in a)
    return a


def _spy_rows(monkeypatch):
    """Record every ``slot_rows`` / ``window_rows`` call of a step with the
    kernel's result, and run the same call on CPU copies of its inputs
    (the twin); returns the list of ``(name, kernel result, twin
    result)``."""
    seen = []
    real_rows, real_window = ops.slot_rows, ops.window_rows

    def rows(tiers, fill, cells, *a, **kw):
        got = real_rows(tiers, fill, cells, *a, **kw)
        twin = real_rows(_on_cpu(tiers), fill, _on_cpu(cells), *a, **kw)
        seen.append(("slot_rows", got.cpu(), twin))
        return got

    def window(tiers, fill, out, order, cid, slot, p0, p1, *a, **kw):
        twin = out.cpu()  # the twin writes its rows into this copy
        win = real_window(tiers, fill, out, order, cid, slot, p0, p1, *a,
                          **kw)
        twin_win = real_window(_on_cpu(tiers), fill, twin, order.cpu(),
                               cid.cpu(), slot.cpu(), p0.cpu(), p1.cpu(), *a,
                               **kw)
        seen.append(("window_rows", out.cpu(), twin))
        if win is not None:
            seen.append(("window", win.cpu(), twin_win))
        return win

    monkeypatch.setattr(ops, "slot_rows", rows)
    monkeypatch.setattr(ops, "window_rows", window)
    return seen


def _bits_equal(a, b):
    return (a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1m-summation", "1m-continuity-options",
                                  "wide-summation", "slab3", "slab3-emit",
                                  "block2d"])
def test_row_kernel_equals_its_twin_on_the_card(cuda, case, monkeypatch,
                                                tmp_path):
    """``slot_rows_kernel`` against its CPU twin, bit for bit, on every row
    call of one step: the 1M dam break's first step (the flagship spill
    summation step; continuity with XSPH and surface tension), the single
    tier at K = 128, a 3-slab slab step silent and emitting (the window's
    particle rows and its frame rows), and a (2, 2) block step; the row
    kernel launches once a finish, a slab and a shard."""
    from tpgsd_torch.sph import make_slab_step_fn

    seen = _spy_rows(monkeypatch)
    ops.reset_launch_counts()
    if case.startswith("1m"):
        continuity = "continuity" in case
        db = dam_break(n_side=86, capacity="auto", capacity_headroom=1.15,
                       device=cuda)
        grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
        state = db.state
        opts = {}
        if continuity:
            state = init_density(state, grid, db.params, device=cuda)
            opts = {"xsph": 0.5, "surface_tension": 0.05}
            seen.clear()  # the seed's rows are not the step's
            ops.reset_launch_counts()
        step = make_step_fn(grid, db.params, device=cuda,
                            density_mode="continuity" if continuity
                            else "summation", **opts)
        assert step.resolved["spill"]
        step(state)
        want_launches = 1
    elif case == "wide-summation":
        db = dam_break(n_side=30, capacity=128, device=cuda)
        step = make_step_fn(db.grid, db.params, device=cuda)
        assert not step.resolved["spill"]
        step(db.state)
        want_launches = 1
    elif case.startswith("slab3"):
        db, state = _slab_state(cuda, 24, "summation")
        if case.endswith("emit"):
            from tpgsd_torch.io_runtime import SlabDumpChannel
            from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

            chan = SlabDumpChannel(
                ShardedFrameWriter(str(tmp_path / "f.gsd"), comm=SingleComm()),
                n=db.n, n_slabs=3, keys=("position", "density"))
            step = make_slab_step_fn(db.grid, db.params, 3, device=cuda,
                                     slab_emit=chan.slab_emit)
            step(state, chan.dump(0))
            chan.close()
        else:
            make_slab_step_fn(db.grid, db.params, 3, device=cuda)(state)
        want_launches = 3
    else:
        _db, mesh, dist, _cap, step_k, _step_p = _block_pair(
            cuda, "2d", "spill", "summation")
        ops.reset_launch_counts()
        step_k(dist)
        want_launches = mesh.size
    torch.cuda.synchronize()
    assert ops.row_launch_counts == {"slot_rows": want_launches}
    assert set(ops.launch_counts) == PAIR_LAUNCH_KEYS
    names = [s[0] for s in seen]
    if case.startswith("slab3"):
        assert names.count("window_rows") == 3
        assert names.count("window") == (3 if case.endswith("emit") else 0)
    else:
        assert names == ["slot_rows"] * want_launches
    for name, got, twin in seen:
        assert _bits_equal(got, twin), name


@pytest.mark.cuda
def test_window_rows_kernel_equals_its_twin_with_overflow(cuda):
    """The slab step's window rows on the card against the twin, bit for
    bit, where the window is narrower than a slab and where it is wider:
    a window writes its own slab's rows alone, the rows that no window
    reaches keep the fill row, and the window-order rows past the slab's
    end are the fill row; a 3-slab step's three windows in turn."""
    from tpgsd_torch.sph.bigstep import _PAD, _slab_geometry, _sorted_rows

    db, state = _slab_state(cuda, 24, "summation")
    grid, k = db.grid, db.grid.capacity
    nxl, c_ext, ext_grid = _slab_geometry(grid, 3)
    nynz = grid.dims[1] * grid.dims[2]
    order, cid_pad, slot_pad, _vs, starts_ext, _c, _o = _sorted_rows(
        state, grid, 2 * k, False)
    n = order.shape[0]
    g = torch.Generator().manual_seed(21)
    fill = (0.0, 0.0, 0.0, 1000.0, 0.0)
    out = torch.tensor(fill).expand(n, 5).clone().to(cuda)
    twin = out.cpu()
    ops.reset_launch_counts()
    for width in (50, n):
        for s in range(3):
            tiers = [[torch.randn((5, c_ext, k), generator=g)
                      .permute(1, 2, 0).to(cuda)] for _ in range(2)]
            p0 = starts_ext[s * nxl * nynz + _PAD * nynz]
            p1 = starts_ext[(s + 1) * nxl * nynz + _PAD * nynz]
            args = (grid.dims, ext_grid.dims, (_PAD - s * nxl, 0, 0))
            win = ops.window_rows(tiers, fill, out, order, cid_pad, slot_pad,
                                  p0, p1, width, *args, emit=True)
            twin_win = ops.window_rows(
                _on_cpu(tiers), fill, twin, order.cpu(), cid_pad.cpu(),
                slot_pad.cpu(), p0.cpu(), p1.cpu(), width, *args, emit=True)
            assert _bits_equal(win.cpu(), twin_win)
            own = int(p1 - p0)
            if width > own:
                assert bool((twin_win[own:] == torch.tensor(fill)).all())
        assert _bits_equal(out.cpu(), twin)
    assert ops.row_launch_counts == {"slot_rows": 6}
