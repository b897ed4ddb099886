"""The port's ``resume`` on the CPU, mirroring tests/test_checkpoint.py:
the trajectory continues at the next step number, an empty file raises,
continuity mode seeds ``state.rho`` from the last frame (and raises
without a density chunk), extra chunks come back; and the port's resume
of a file the JAX package wrote.  Every resume runs with
``comm=SingleComm()``.  Resumed states are bit-identical to what was
dumped (float32 frames are exact), so the resumed step is too.
"""

import inspect

import numpy
import pytest
import torch

import jax

import tpgsd_torch.hoomd
from tpgsd.parallel import ShardedFrameWriter as RefFrameWriter
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.sph import (
    dam_break,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
    resume,
    run_adaptive,
)


def _run(step, state, writer, n, start_step=0):
    for i in range(n):
        state, (rho, p, _) = step(state)
        writer.write_frame(
            {
                "particles/position": state.x,
                "particles/velocity": state.v,
                "particles/density": rho,
            },
            step=start_step + i,
        )
    return state


def test_resume_continues_trajectory(tmp_path):
    db = dam_break(n_side=5, device="cpu")
    step = make_step_fn(db.grid, db.params, device="cpu")
    path = tmp_path / "resumable.gsd"
    writer = ShardedFrameWriter(path, comm=SingleComm())
    state1 = _run(step, db.state, writer, 3)
    writer.close()

    state2, last_step, writer, extras = resume(path, comm=SingleComm(),
                                               device="cpu")
    assert last_step == 2 and extras == {} and state2.rho is None
    assert state2.x.device == torch.device("cpu")
    assert torch.equal(state2.x, state1.x) and torch.equal(state2.v, state1.v)
    _run(step, state2, writer, 2, start_step=3)
    writer.close()

    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        assert [int(f.configuration.step) for f in traj] == [0, 1, 2, 3, 4]
        # frame 3 is one step from frame 2
        ref, _ = step(state1)
        numpy.testing.assert_array_equal(traj[3].particles.position,
                                         ref.x.numpy())


def test_resume_reads_extra_chunks(tmp_path):
    db = dam_break(n_side=4, device="cpu")
    path = tmp_path / "extras.gsd"
    slength = torch.full((db.n,), db.params.h)
    with ShardedFrameWriter(path, comm=SingleComm()) as writer:
        writer.write_frame({"particles/position": db.state.x,
                            "particles/velocity": db.state.v,
                            "particles/slength": slength})
    state, last_step, writer, extras = resume(
        path, comm=SingleComm(), device="cpu",
        extra_chunks=["particles/slength"],
    )
    writer.close()
    assert last_step == 0  # no configuration/step chunk: nframes - 1
    assert torch.equal(extras["particles/slength"], slength)
    assert torch.equal(state.x, db.state.x)


def test_resume_empty_trajectory_raises(tmp_path):
    path = tmp_path / "empty.gsd"
    ShardedFrameWriter(path, comm=SingleComm()).close()
    with pytest.raises(ValueError, match="empty"):
        resume(path, comm=SingleComm(), device="cpu")


def test_resume_continuity_seeds_rho(tmp_path):
    """Continuity resume loads the carried density; the resumed adaptive
    run continues the uninterrupted one bit for bit, from the kept dt."""
    db = dam_break(n_side=5, device="cpu")
    step = make_adaptive_step_fn(db.grid, db.params,
                                 density_mode="continuity", device="cpu")
    state0 = init_density(db.state, db.grid, db.params, device="cpu")
    path = tmp_path / "cont_resume.gsd"
    writer = ShardedFrameWriter(path, comm=SingleComm())
    s, dt = state0, torch.tensor(db.params.dt, dtype=torch.float32)
    for i in range(3):
        s, _aux, dt = step(s, dt)
        writer.write_frame({"particles/position": s.x,
                            "particles/velocity": s.v,
                            "particles/density": s.rho}, step=i)
    writer.close()

    state2, last_step, writer2, _ = resume(path, comm=SingleComm(),
                                           device="cpu",
                                           density_mode="continuity")
    writer2.close()
    assert last_step == 2
    assert torch.equal(state2.rho, s.rho)
    s_resumed, dt_resumed, _ = run_adaptive(step, state2, dt, 2)
    s_direct, dt_direct, _ = run_adaptive(step, s, dt, 2)
    assert torch.equal(s_resumed.x, s_direct.x)
    assert torch.equal(s_resumed.rho, s_direct.rho)
    assert torch.equal(dt_resumed, dt_direct)


def test_resume_continuity_missing_density_raises(tmp_path):
    db = dam_break(n_side=4, device="cpu")
    path = tmp_path / "nodensity.gsd"
    with ShardedFrameWriter(path, comm=SingleComm()) as writer:
        writer.write_frame({"particles/position": db.state.x,
                            "particles/velocity": db.state.v}, step=0)
    with pytest.raises(ValueError, match="particles/density"):
        resume(path, comm=SingleComm(), device="cpu",
               density_mode="continuity")


def test_resume_reads_a_trajectory_the_jax_package_wrote(tmp_path):
    """A frame written by the JAX package's writer resumes in the port
    with the same positions and step number."""
    db = ref_dam_break(n_side=4)
    x = numpy.asarray(db.state.x)
    path = tmp_path / "from_jax.gsd"
    writer = RefFrameWriter(path)
    writer.write_frame({"particles/position": jax.numpy.asarray(x),
                        "particles/velocity": jax.numpy.zeros_like(x)},
                       step=7)
    writer.close()
    state, last_step, writer, _ = resume(path, comm=SingleComm(),
                                         device="cpu")
    writer.close()
    assert last_step == 7
    numpy.testing.assert_array_equal(state.x.numpy(), x)


def test_resume_needs_a_communicator_and_defaults_to_the_card():
    params = inspect.signature(resume).parameters
    assert params["comm"].kind is inspect.Parameter.KEYWORD_ONLY
    assert params["comm"].default is inspect.Parameter.empty
    assert params["device"].default == "cuda"
