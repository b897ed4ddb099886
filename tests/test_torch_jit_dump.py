"""The port's in-loop dumps (``JitDumpChannel``, ``scan_simulate``,
``scan_simulate_adaptive``) on the CPU, mirroring tests/test_jit_dump.py:
the cadence, frames equal to the state after each emitted step (bit for
bit: the dump copies float32 tensors), and the real SPH step, read back
through ``tpgsd_torch.hoomd``.
"""

import numpy
import pytest
import torch

import tpgsd_torch.fl
import tpgsd_torch.hoomd
from tpgsd_torch.io_runtime import (
    JitDumpChannel,
    scan_simulate,
    scan_simulate_adaptive,
)
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.sph import (
    dam_break,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
    run_adaptive,
)


def _writer(path):
    return ShardedFrameWriter(path, comm=SingleComm())


def test_emit_and_maybe_emit(tmp_path):
    """``emit`` writes a frame now; ``maybe_emit`` only when the host
    counter hits the cadence, under the given step number."""
    path = tmp_path / "emit.gsd"
    x = torch.ones((8, 3))
    with JitDumpChannel(_writer(path), ["particles/position"]) as channel:
        channel.emit([2.0 * x], 0)
        for i in range(1, 6):
            channel.maybe_emit(i, 2, [x * i], step=10 + i)
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert [int(f.configuration.step) for f in traj] == [0, 12, 14]
        numpy.testing.assert_array_equal(traj[0].particles.position,
                                         numpy.full((8, 3), 2.0))
        numpy.testing.assert_array_equal(traj[2].particles.position,
                                         numpy.full((8, 3), 4.0))


def test_scan_simulate_with_cadence(tmp_path):
    path = tmp_path / "scan.gsd"

    def step(state):
        return state + 1.0, torch.sum(state)

    channel = JitDumpChannel(_writer(path), ["state/values"])
    final = scan_simulate(step, torch.zeros(4), n_steps=10, channel=channel,
                          frame_of=lambda s, aux: [s], every=3)
    assert channel.stats.frames == 4  # flushed before the return
    channel.close()
    numpy.testing.assert_array_equal(final.numpy(), numpy.full(4, 10.0))
    with tpgsd_torch.fl.open(path, "r") as f:
        assert f.nframes == 4  # steps 0, 3, 6, 9
        for frame, stepval in enumerate([0, 3, 6, 9]):
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "state/values"),
                numpy.full(4, float(stepval) + 1.0, numpy.float32),
            )
            assert f.read_chunk(frame, "configuration/step")[0] == stepval


@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
def test_scan_simulate_sph_frames_are_the_states(tmp_path, density_mode):
    """Five steps of the real step, a frame at i = 0, 2, 4: each frame is
    the state after ``i + 1`` steps of a rollout without a dump."""
    db = dam_break(n_side=5, device="cpu")
    step = make_step_fn(db.grid, db.params, density_mode=density_mode,
                        device="cpu")
    state0 = db.state
    if density_mode == "continuity":
        state0 = init_density(state0, db.grid, db.params, device="cpu")
    states, s = [], state0
    for _ in range(5):
        s, _aux = step(s)
        states.append(s)

    path = tmp_path / "sph_scan.gsd"
    channel = JitDumpChannel(_writer(path),
                             ["particles/position", "particles/velocity",
                              "particles/density"])
    final = scan_simulate(step, state0, n_steps=5, channel=channel,
                          frame_of=lambda s, aux: [s.x, s.v, aux[0]],
                          every=2)
    channel.close()
    assert torch.equal(final.x, states[-1].x)
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 3
        for frame, i in zip(traj, (0, 2, 4)):
            assert frame.configuration.step == i
            numpy.testing.assert_array_equal(frame.particles.position,
                                             states[i].x.numpy())
            numpy.testing.assert_array_equal(frame.particles.velocity,
                                             states[i].v.numpy())
            assert numpy.isfinite(frame.particles.density).all()
        if density_mode == "continuity":
            numpy.testing.assert_array_equal(traj[2].particles.density,
                                             states[4].rho.numpy())


def test_scan_simulate_adaptive_sph(tmp_path):
    """The adaptive rollout with dumps: ``(state, dt_next, t)`` equal to
    ``run_adaptive``'s, ``t`` within the steps' fixed-dt span, frames at
    i = 0, 3 equal to the states after 1 and 4 steps."""
    db = dam_break(n_side=5, device="cpu")
    step = make_adaptive_step_fn(db.grid, db.params, device="cpu")
    path = tmp_path / "sph_scan_ad.gsd"
    channel = JitDumpChannel(_writer(path),
                             ["particles/position", "particles/density"])
    final, dt_next, t = scan_simulate_adaptive(
        step, db.state, db.params.dt, n_steps=6, channel=channel,
        frame_of=lambda s, aux: [s.x, aux[0]], every=3,
    )
    channel.close()
    s_run, dt_run, t_run = run_adaptive(step, db.state, db.params.dt, 6)
    assert torch.equal(final.x, s_run.x)
    assert torch.equal(dt_next, dt_run) and torch.equal(t, t_run)
    assert 0 < float(dt_next) <= db.params.dt
    assert 0 < float(t) <= 6 * db.params.dt + 1e-9
    after = {}
    for n in (1, 4):
        after[n], _, _ = run_adaptive(step, db.state, db.params.dt, n)
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 2
        assert [int(f.configuration.step) for f in traj] == [0, 3]
        for frame, n in zip(traj, (1, 4)):
            numpy.testing.assert_array_equal(frame.particles.position,
                                             after[n].x.numpy())


def test_channel_surfaces_a_writer_error():
    """A failing writer raises at the next call, not silently."""

    class Broken:
        def write_frame(self, chunks, step=None):
            raise OSError("disk full")

        def flush(self):
            pass

        def close(self):
            pass

    channel = JitDumpChannel(Broken(), ["particles/position"])
    channel.emit([torch.zeros((2, 3))], 0)
    with pytest.raises(RuntimeError, match="writer failed"):
        channel.flush()
    channel.close()
