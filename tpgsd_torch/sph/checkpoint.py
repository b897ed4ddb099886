"""Checkpoint / resume for simulation dump loops (torch counterpart of
``tpgsd.sph.checkpoint``).

The trajectory file *is* the checkpoint (the reference notes the same
usage for restart files, reference: pgsd/pgsd/pgsd.h:442-449): every
``end_frame`` is a crash-consistent restart point, and append mode
continues exactly after the last complete frame (reference:
pgsd/pgsd/pgsd.c:1630-1639 frame-counter derivation).

:func:`resume` reads the last frame back through the port's
:class:`~tpgsd_torch.parallel.ShardedTrajectoryReader` onto a device and
returns the writer positioned to append; :func:`resume_distributed`,
:func:`resume_distributed2d` and :func:`resume_distributed3d`
re-partition the last frame onto a mesh for the slab, 2-D and 3-D block
decompositions.
"""

import numpy

from ..parallel.comm import SingleComm
from ..parallel.shard_io import ShardedFrameWriter, ShardedTrajectoryReader
from .step import SPHState


def _require_density(f, last, name):
    """Guard for continuity-mode resume: the last frame must carry the
    ``particles/density`` chunk (the evolved density IS state there -
    re-summing it from positions would discard the advected field)."""
    if not f.chunk_exists(last, "particles/density"):
        raise ValueError(
            "density_mode='continuity' resume needs a particles/density "
            "chunk in the last frame of %s - dump the carried density "
            "alongside positions, or seed with tpgsd_torch.sph.init_density "
            "instead" % (name,)
        )


def resume(name, *, comm, device="cuda", extra_chunks=(),
           application="tpgsd.sph", density_mode="summation"):
    """Resume a dump loop from the last complete frame of ``name``.

    Args:
        name: trajectory file path (must exist and hold >= 1 frame).
        comm: the communicator (required, as the reader's and writer's
            are; ``SingleComm()`` in one process).  Each process reads
            its own row stripe, all rows with ``SingleComm``.
        device: where the state is placed (the card unless the caller
            asks for ``"cpu"``).
        extra_chunks: more chunk names to load beside position and
            velocity.
        application: the writer's application name.
        density_mode: ``"continuity"`` also loads the last frame's
            ``particles/density`` chunk into ``state.rho`` (the carried
            density a continuity-mode step needs; raises if the frame has
            none).

    Returns:
        ``(state, step, writer, extras)``: the :class:`SPHState` of the
        last frame on ``device``, its ``configuration/step`` value (or
        ``nframes - 1``), a :class:`ShardedFrameWriter` opened in append
        mode whose next ``write_frame`` lands at ``frame == nframes``, and
        a dict of the extra chunks.
    """
    continuity = density_mode == "continuity"
    with ShardedTrajectoryReader(name, comm=comm, device=device) as reader:
        if reader.nframes == 0:
            raise ValueError("cannot resume from an empty trajectory: " + str(name))
        last = reader.nframes - 1
        want = ["particles/position", "particles/velocity"]
        if continuity:
            _require_density(reader.file, last, name)
            want.append("particles/density")
        chunks = {
            k: tensor
            for k, (_start, tensor) in reader.read_frame(
                last, want + list(extra_chunks)
            ).items()
        }
        if reader.file.chunk_exists(last, "configuration/step"):
            step = int(reader.file.read_chunk(last, "configuration/step")[0])
        else:
            step = last
    state = SPHState(
        x=chunks["particles/position"],
        v=chunks["particles/velocity"],
        rho=chunks["particles/density"] if continuity else None,
    )
    writer = ShardedFrameWriter(name, mode="a", application=application,
                                comm=comm)
    extras = {k: chunks[k] for k in extra_chunks}
    return state, step, writer, extras


def _last_frame(name, continuity, comm):
    """``(SPHState of numpy arrays, step)`` of the last frame of
    ``name``, read whole (``rho`` only in continuity mode); every process
    of ``comm`` opens the file collectively and reads it whole."""
    from .. import fl

    rho = None
    with fl.open(name, "r", comm=comm) as f:
        if f.nframes == 0:
            raise ValueError(
                "cannot resume from an empty trajectory: " + str(name))
        last = f.nframes - 1
        x = numpy.asarray(f.read_chunk(last, "particles/position"))
        v = numpy.asarray(f.read_chunk(last, "particles/velocity"))
        if continuity:
            _require_density(f, last, name)
            rho = numpy.asarray(f.read_chunk(last, "particles/density"))
        if f.chunk_exists(last, "configuration/step"):
            step = int(f.read_chunk(last, "configuration/step")[0])
        else:
            step = last
    return SPHState(x=x, v=v, rho=rho), step


def _resume_onto(name, distribute, application, density_mode, comm):
    comm = SingleComm() if comm is None else comm
    state, step = _last_frame(name, density_mode == "continuity", comm)
    dist, cap = distribute(state)
    writer = ShardedFrameWriter(name, mode="a", application=application,
                                comm=comm)
    return dist, cap, step, writer


def resume_distributed(name, grid, mesh, capacity=None,
                       application="tpgsd.sph", decomp_axis=0,
                       density_mode="summation", comm=None):
    """Resume the slab-decomposed loop from the last complete frame of
    ``name``.

    The particles are re-partitioned into slab ownership for ``mesh``
    (:func:`~tpgsd_torch.sph.distributed.distribute_state`), whose size
    may differ from the writing run's: ownership is re-derived from the
    positions.  ``decomp_axis`` selects x- (0) or y-slabs (1), as the
    step builder's.  ``density_mode="continuity"`` also re-slabs the
    frame's ``particles/density`` chunk into ``DistState.rho``: the
    carried density travels with its particle.  Every process reads the
    file whole, collectively over ``comm``, and puts its own shards of
    ``mesh`` on their devices; the appending writer takes ``comm`` too.
    ``comm=None`` is one process driving every shard (``SingleComm()``);
    with a mesh over several processes pass the mesh's
    :class:`~tpgsd_torch.parallel.TorchProcessComm`.

    Returns:
        ``(dist_state, capacity, step, writer)``: the
        :class:`~tpgsd_torch.sph.distributed.DistState` on the mesh's
        devices, the slots a shard, the last ``configuration/step`` value
        (or ``nframes - 1``) and a :class:`ShardedFrameWriter` opened in
        append mode.
    """
    from .distributed import distribute_state

    return _resume_onto(name, lambda st: distribute_state(
        st, grid, mesh, capacity=capacity, decomp_axis=decomp_axis),
        application, density_mode, comm)


def resume_distributed2d(name, grid, mesh, capacity=None,
                         application="tpgsd.sph", density_mode="summation",
                         comm=None):
    """Resume the 2-D block-decomposed loop from the last complete frame
    of ``name``: as :func:`resume_distributed`, block ownership re-derived
    for the ``(px, py)`` ``mesh``
    (:func:`~tpgsd_torch.sph.distributed2d.distribute_state_2d`), whose
    shape may differ from the writing run's (a file the slab or 3-D form
    wrote too: the file records the global state only); ``comm`` as
    :func:`resume_distributed`'s.

    Returns:
        ``(dist_state, capacity, step, writer)`` as
        :func:`resume_distributed`.
    """
    from .distributed2d import distribute_state_2d

    return _resume_onto(name, lambda st: distribute_state_2d(
        st, grid, mesh, capacity=capacity), application, density_mode, comm)


def resume_distributed3d(name, grid, mesh, capacity=None,
                         application="tpgsd.sph", density_mode="summation",
                         comm=None):
    """Resume the 3-D block-decomposed loop from the last complete frame
    of ``name`` onto a ``(px, py, pz)`` ``mesh``, as
    :func:`resume_distributed2d`
    (:func:`~tpgsd_torch.sph.distributed3d.distribute_state_3d`)."""
    from .distributed3d import distribute_state_3d

    return _resume_onto(name, lambda st: distribute_state_3d(
        st, grid, mesh, capacity=capacity), application, density_mode, comm)
