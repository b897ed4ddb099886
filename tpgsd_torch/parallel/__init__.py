"""Sharded trajectory I/O for torch tensors (the port's copy of
``tpgsd.parallel``).

The replacement for the reference's MPI-rank parallelism (reference:
pgsd/pgsd/pgsd.c MPI_File_* + MPI_Allgather offset protocol):

* one controller process commits metadata (index/namelist/header),
  replacing rank-0 logic (reference: pgsd/pgsd/pgsd.c:1531-1607).
* every process pwrites only its shards at disjoint offsets into the
  shared file - the role of ``MPI_File_write_at``.

Every writer and reader takes its communicator explicitly (``comm=``):
:class:`SingleComm` in one process, :class:`TorchProcessComm` with one
process per rank (``torch.distributed``; :mod:`.launch` starts the group
and spawns the workers).  With one process per rank a global array is a
:class:`ProcessShards` on each process; :class:`ShardedFrameWriter` and
:class:`ComposedFrameWriter` write only this process's shards.

:func:`make_mesh` builds the 1-D device mesh of the slab-decomposed SPH
step (:mod:`tpgsd_torch.sph.distributed`), :func:`make_mesh2d` and
:func:`make_mesh3d` the block meshes of the 2-D and 3-D decompositions.
One process drives every shard, or, with ``comm=``, each process its
own; :class:`~.exchange.Exchange` carries the halos and migrants between
them.
"""

from .shard_io import (  # noqa: F401
    ProcessShards,
    ShardedFrameWriter,
    ShardedTrajectoryReader,
    array_shards,
    read_sharded_chunk,
    stripe_rows,
    write_sharded_chunk,
)
from .comm import SingleComm, TorchProcessComm  # noqa: F401
from .compose_io import ComposedFrameWriter, compose  # noqa: F401
from .mesh import Mesh, make_mesh, make_mesh2d, make_mesh3d  # noqa: F401
from .fs import direct_write_policy, filesystem_kind  # noqa: F401
