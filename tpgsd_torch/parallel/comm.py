"""Host-process communicators for multi-process coordination (the port's
copy of ``tpgsd.parallel.comm``).

The file layer (``tpgsd_torch.fl``) takes a communicator with this small
five-method interface (``allgather``, ``bcast``, ``barrier``,
``allreduce_sum``, ``allreduce_max``, plus ``rank`` and ``size``) - the
structural equivalent of the reference's MPI ranks (reference:
pgsd/pgsd/pgsd.c:106-172 Bcast helpers and pgsd.c:1121-1152 Allgather
offset protocol).  ``SingleComm`` covers the single-controller case (one
process, any number of devices); ``TorchProcessComm`` covers one process
per rank over ``torch.distributed``, where every process owns some of the
shards and writes its own.  There is no default communicator: every
writer is handed one explicitly.
"""

from datetime import timedelta


class SingleComm:
    """Single-process communicator: every collective is the identity."""

    rank = 0
    size = 1

    def allgather(self, value):
        return [value]

    def bcast(self, value, root=0):
        return value

    def barrier(self):
        pass

    def allreduce_sum(self, value):
        return value

    def allreduce_max(self, value):
        return value


class TorchProcessComm:
    """Communicator over ``torch.distributed`` (the counterpart of the
    reference's ``JaxProcessComm``).

    It needs ``torch.distributed.init_process_group`` to have run in every
    process (:func:`tpgsd_torch.parallel.launch.init_process_group` does
    both).  The values travel pickled over a Gloo group of the
    communicator's own, whatever backend the default group has, so NCCL
    device traffic and this host metadata never share a group.  Like the
    reference's, it carries metadata only (offsets, names, index entries,
    scalars): the data bytes go straight from each process to the file.

    Building one is collective: every process of the default group
    creates it, in the same order as its other collectives.
    """

    def __init__(self, timeout=timedelta(seconds=60)):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "TorchProcessComm needs torch.distributed.init_process_group "
                "to have run in every process"
            )
        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if dist.get_backend() == "gloo":
            self._group = dist.group.WORLD
        else:
            self._group = dist.new_group(backend="gloo", timeout=timeout)

    def allgather(self, value):
        out = [None] * self.size
        self._dist.all_gather_object(out, value, group=self._group)
        return out

    def bcast(self, value, root=0):
        """Broadcast an arbitrary picklable value from ``root`` (the other
        ranks pass anything, usually ``None``, and get root's value)."""
        box = [value if self.rank == root else None]
        self._dist.broadcast_object_list(box, src=root, group=self._group)
        return box[0]

    def barrier(self):
        self._dist.barrier(group=self._group)

    def allreduce_sum(self, value):
        return sum(self.allgather(value))

    def allreduce_max(self, value):
        return max(self.allgather(value))
