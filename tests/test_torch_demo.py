"""The port's demo (``examples/dam_break_demo_torch.py``, run in-process
through ``main``), its on-device lattice (``dam_break(on_device=True)``,
mirroring tests/test_scenarios.py's test against the host lattice) and
its VTU export (``tpgsd_torch.vtu``, held to ``tpgsd.vtu``'s bytes), on
the CPU.
"""

import os
import sys

import numpy
import pytest

import tpgsd.vtu
import tpgsd_torch.hoomd
import tpgsd_torch.vtu
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd_torch.sph import dam_break

sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), os.pardir, "examples")
)
import dam_break_demo_torch  # noqa: E402


@pytest.mark.parametrize(
    "flags, resolved",
    [(["--adaptive"], "'spill': False, 'density_mode': 'summation'"),
     (["--density-mode", "continuity", "--spill"],
      "'spill': True, 'density_mode': 'continuity'")],
    ids=["adaptive", "continuity_spill"],
)
def test_demo_writes_a_readable_trajectory(tmp_path, capsys, flags, resolved):
    out = str(tmp_path / "demo.gsd")
    dam_break_demo_torch.main(
        ["--device", "cpu", "--n-side", "5", "--steps", "4", "--every", "2",
         "--out", out] + flags
    )
    printed = capsys.readouterr().out
    assert resolved in printed
    assert "dumped 2 frames" in printed
    assert ("adaptive dt: simulated" in printed) == ("--adaptive" in flags)
    with tpgsd_torch.hoomd.open(out, mode="r") as traj:
        assert len(traj) == 2
        assert [int(f.configuration.step) for f in traj] == [0, 2]
        part = traj[1].particles
        assert part.N == 180
        for name in ("position", "velocity", "density", "pressure"):
            assert numpy.isfinite(getattr(part, name)).all()
        numpy.testing.assert_allclose(part.slength, 1.3 * 0.8 / 5, rtol=1e-6)


@pytest.mark.parametrize("flags", [[], ["--adaptive", "--density-mode",
                                          "continuity"]],
                         ids=["fixed", "adaptive_continuity"])
def test_demo_slab_decomposition(tmp_path, capsys, flags):
    """``--decomp slab``: the shards on the CPU, frames gathered by pid
    through collect_state / collect_aux; the same trajectory as the
    global step's within the reference's decomposition tolerances."""
    _hold_decomposed_demo(tmp_path, capsys, flags, "slab", 2,
                          "decomposed (slab) over 2 shards on cpu")


@pytest.mark.parametrize("flags", [[], ["--adaptive", "--density-mode",
                                          "continuity"]],
                         ids=["fixed", "adaptive_continuity"])
@pytest.mark.parametrize("decomp,shards,shape", [("2d", 4, (2, 2)),
                                                 ("3d", 8, (2, 2, 2))])
def test_demo_block_decomposition(tmp_path, capsys, flags, decomp, shards,
                                  shape):
    """``--decomp 2d`` / ``3d``: the block shape the JAX demo fits to the
    4 x 2 x 2 cells, frames gathered by pid; the global step's trajectory
    within the reference's decomposition tolerances."""
    _hold_decomposed_demo(
        tmp_path, capsys, flags, decomp, shards,
        "decomposed (%s) over %d shards on cpu, block shape %s"
        % (decomp, shards, shape))


def _hold_decomposed_demo(tmp_path, capsys, flags, decomp_kind, shards,
                          message):
    frames = {}
    for decomp in (["--decomp", decomp_kind, "--shards", str(shards)], []):
        out = str(tmp_path / ("demo%d.gsd" % len(decomp)))
        dam_break_demo_torch.main(
            ["--device", "cpu", "--n-side", "5", "--steps", "4", "--every",
             "2", "--out", out] + decomp + flags
        )
        printed = capsys.readouterr().out
        assert (message in printed) == bool(decomp)
        assert "dumped 2 frames" in printed
        with tpgsd_torch.hoomd.open(out, mode="r") as traj:
            assert [int(f.configuration.step) for f in traj] == [0, 2]
            frames[bool(decomp)] = [
                (f.particles.position, f.particles.velocity,
                 f.particles.density) for f in traj]
    for (x_d, v_d, r_d), (x_g, v_g, r_g) in zip(frames[True], frames[False]):
        assert x_d.shape == (180, 3)
        numpy.testing.assert_allclose(x_d, x_g, rtol=5e-4, atol=5e-5)
        numpy.testing.assert_allclose(v_d, v_g, rtol=5e-3, atol=5e-3)
        numpy.testing.assert_allclose(r_d, r_g, rtol=1e-4)


def test_demo_slab_shards_must_divide_the_x_cells(tmp_path):
    """``--shards`` that does not divide the x cells raises rather than
    running fewer shards."""
    nx = dam_break(n_side=5, device="cpu").grid.dims[0]
    shards = min(s for s in range(2, nx + 2) if nx % s)
    with pytest.raises(ValueError, match="must divide the grid's %d x cells"
                       % nx):
        dam_break_demo_torch.main(
            ["--device", "cpu", "--n-side", "5", "--steps", "1", "--out",
             str(tmp_path / "demo.gsd"), "--decomp", "slab", "--shards",
             str(shards)])


@pytest.mark.parametrize("decomp,shards", [("2d", 3), ("3d", 3)])
def test_demo_block_shards_must_fit_the_grid(tmp_path, decomp, shards):
    """A ``--shards`` count that no block shape of the 4 x 2 x 2 cells uses
    whole raises rather than running fewer shards."""
    with pytest.raises(ValueError, match="no %s block shape" % decomp):
        dam_break_demo_torch.main(
            ["--device", "cpu", "--n-side", "5", "--steps", "1", "--out",
             str(tmp_path / "demo.gsd"), "--decomp", decomp, "--shards",
             str(shards)])


def test_demo_on_device_lattice_and_vtu(tmp_path, capsys):
    out = str(tmp_path / "lattice.gsd")
    dam_break_demo_torch.main(
        ["--device", "cpu", "--n-side", "5", "--steps", "2", "--every", "1",
         "--on-device", "--vtu", "--out", out]
    )
    assert "wrote 2 .vtu files" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.glob("*.vtu")) == [
        "lattice_00001.vtu", "lattice_00002.vtu"]
    with pytest.raises(SystemExit, match="dam_break lattice only"):
        dam_break_demo_torch.main(["--device", "cpu", "--scenario",
                                   "taylor_green", "--on-device"])


@pytest.mark.parametrize("n_side", [8, 12, 20])
def test_dam_break_on_device_matches_host_lattice(n_side):
    """The arange lattice and the lattice-geometry capacity reproduce the
    host lattice: the same count, grid and auto capacity, positions equal
    to float32 rounding; and the JAX package's on-device lattice."""
    a = dam_break(n_side=n_side, capacity="auto", device="cpu")
    b = dam_break(n_side=n_side, capacity="auto", device="cpu",
                  on_device=True)
    assert a.n == b.n
    assert a.grid == b.grid
    assert a.params == b.params
    numpy.testing.assert_allclose(a.state.x.numpy(), b.state.x.numpy(),
                                  atol=1e-6)
    assert not b.state.v.any()
    ref = ref_dam_break(n_side=n_side, capacity="auto", on_device=True,
                        capacity_headroom=1.15)
    c = dam_break(n_side=n_side, capacity="auto", device="cpu",
                  on_device=True, capacity_headroom=1.15)
    assert c.grid.capacity == ref.grid.capacity
    numpy.testing.assert_array_equal(c.state.x.numpy(),
                                     numpy.asarray(ref.state.x))


@pytest.mark.parametrize("ascii_format", [False, True], ids=["binary", "ascii"])
def test_vtu_writes_the_reference_bytes(tmp_path, ascii_format):
    rng = numpy.random.default_rng(0)
    points = rng.standard_normal((7, 3)).astype(numpy.float32)
    data = {"density": rng.standard_normal(7).astype(numpy.float32),
            "velocity": rng.standard_normal((7, 3)).astype(numpy.float32)}
    tpgsd.vtu.write_vtu(tmp_path / "a.vtu", points, data, ascii_format)
    tpgsd_torch.vtu.write_vtu(tmp_path / "b.vtu", points, data, ascii_format)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()
