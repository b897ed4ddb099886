"""Frame dumps from inside a rollout (torch counterpart of
``tpgsd.io_runtime.jit_dump``; the names are kept so a reader finds the
counterpart).

The reference compiles the whole rollout into one ``lax.scan`` and
emits frames through an ordered ``io_callback``.  Here the rollout is an
eager Python loop: the host queues each step's kernels and runs ahead of
the card, and a frame goes through the port's
:class:`~tpgsd_torch.io_runtime.AsyncDumpRunner`.  Its snapshot (a
non-blocking copy into pinned memory, then an event on the stream)
orders each frame after the step that made it and before any later
step, as ``ordered=True`` does in the reference, so :meth:`close` needs
no wait for the device first.  The cadence test ``i % every`` reads the
host's loop counter, a Python int, never a device value.

Example:
    channel = JitDumpChannel(
        ShardedFrameWriter(path, comm=SingleComm()),
        ["particles/position", "particles/velocity"],
    )
    state = scan_simulate(step, state, 1000, channel,
                          frame_of=lambda s, aux: [s.x, s.v], every=10)
    channel.close()
"""

import torch

from ..sph.step import initial_dt, state_device
from .dump import AsyncDumpRunner


class JitDumpChannel:
    """Host-side sink for frames emitted from a rollout.

    Args:
        writer: ShardedFrameWriter (or compatible); owned by default.
        names: chunk names, positionally matching the ``arrays`` passed
            to :meth:`emit` / :meth:`maybe_emit`.
        depth: async queue depth (frames in flight).
    """

    def __init__(self, writer, names, depth=2, own_writer=True):
        self._runner = AsyncDumpRunner(writer, depth=depth, own_writer=own_writer)
        self._names = list(names)

    def emit(self, arrays, step):
        """Emit one frame of ``arrays`` (tensors, in channel-name order)
        as ``configuration/step`` ``step`` (a host int): the snapshot is
        queued on the current stream and the call returns."""
        self._runner.submit(dict(zip(self._names, arrays)), step=int(step))

    def maybe_emit(self, i, every, arrays, step=None):
        """Emit when ``i % every == 0`` (``i`` the host's loop counter)."""
        if i % every == 0:
            self.emit(arrays, i if step is None else step)

    @property
    def stats(self):
        return self._runner.stats

    def flush(self):
        self._runner.flush()

    def close(self):
        """Drain the queued frames and close the writer."""
        self._runner.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self._runner.__exit__(exc_type, exc_value, traceback)


def _synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@torch.inference_mode()
def scan_simulate(step_fn, state, n_steps, channel, frame_of, every=1):
    """A rollout of ``n_steps`` steps with a frame every ``every``-th.

    Args:
        step_fn: ``state -> (state, aux)``.
        state: initial state.
        n_steps: total steps.
        channel: :class:`JitDumpChannel` whose names match ``frame_of``.
        frame_of: ``(state, aux) -> list of tensors`` (in channel-name
            order), called only for the steps that emit.
        every: dump cadence: step ``i`` (from 0) emits its new state as
            step ``i`` when ``i % every == 0``.

    Returns:
        the final state, once the device has finished; the channel is
        flushed but left open.
    """
    for i in range(int(n_steps)):
        state, aux = step_fn(state)
        if i % every == 0:
            channel.emit(frame_of(state, aux), step=i)
    _synchronize()
    channel.flush()
    return state


@torch.inference_mode()
def scan_simulate_adaptive(step_fn, state, dt0, n_steps, channel, frame_of,
                           every=1):
    """Adaptive-dt rollout with a frame every ``every``-th step.

    The carry is ``(state, dt, t)`` on the device, as in
    :func:`tpgsd_torch.sph.run_adaptive`; frames are equally spaced in
    step count, not in simulated time.

    Args:
        step_fn: adaptive step ``(state, dt) -> (state, aux, dt_next)``
            (:func:`tpgsd_torch.sph.make_adaptive_step_fn`).
        state: initial :class:`~tpgsd_torch.sph.SPHState`.
        dt0: the first step's dt (a float or a 0-d tensor).
        n_steps, channel, frame_of, every: as :func:`scan_simulate`.

    Returns:
        ``(state, dt_next, t)`` as device tensors, once the device has
        finished; the channel is flushed but left open.
    """
    dt, t = initial_dt(dt0, state_device(state))
    for i in range(int(n_steps)):
        state, aux, dt_next = step_fn(state, dt)
        if i % every == 0:
            channel.emit(frame_of(state, aux), step=i)
        t = t + dt
        dt = dt_next
    _synchronize()
    channel.flush()
    return state, dt, t
