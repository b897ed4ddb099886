"""Host-process communicators for multi-process coordination (the port's
copy of ``tpgsd.parallel.comm``).

The file layer (``tpgsd_torch.fl``) takes a communicator with this small
five-method interface (``allgather``, ``bcast``, ``barrier``,
``allreduce_sum``, ``allreduce_max``, plus ``rank`` and ``size``) - the
structural equivalent of the reference's MPI ranks (reference:
pgsd/pgsd/pgsd.c:106-172 Bcast helpers and pgsd.c:1121-1152 Allgather
offset protocol).  ``SingleComm`` covers the single-controller case (one
process, any number of devices).  A communicator over
``torch.distributed`` is not written yet; there is no default
communicator, so every writer is handed one explicitly.
"""


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
