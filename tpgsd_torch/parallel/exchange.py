"""The exchange seam of the decomposed SPH steps: halo planes, migrants
and the CFL maxima between the shards of a
:class:`~tpgsd_torch.parallel.Mesh`, within one process and across
processes (the role of the reference's ``lax.ppermute`` and ``pmax``).

A stage of a step hands :class:`Exchange` the messages every one of this
process's shards sends, keyed by what the receiver calls them, and the
routes of every shard of the mesh (``routes[d][key]``: the shard that
``d`` receives ``key`` from, or ``None``).  The exchange runs in two
phases: it posts every send of the stage, then receives.

* Between two shards of this process a message is a copy to the
  receiver's device (``.to(device)``: a view when both share it).  A
  message between two cards is made contiguous on the sender's and
  copied in one peer copy, which PyTorch issues on the sender's stream
  and orders against the receiver's with events (no host sync).
* Between processes every message from one process to another in the
  stage travels in one byte buffer, with one
  ``torch.distributed.batch_isend_irecv`` for the stage on the default
  group.  On NCCL the device buffers go as they are; on Gloo, whose
  point-to-point messages are host tensors, a CUDA buffer is staged
  through pinned host memory (one host sync a stage, counted in
  :data:`stats`).

:data:`stats` counts, since :func:`reset_stats`, what crossed between
processes, what was delivered between shards of this process, and the
decomposed steps taken, so a reader can divide the bytes by the steps.

No size handshake is needed: every message a shard receives under a key
has the shape and dtype of the message it sends under that key (the
ghost planes are fixed by the grid, the migrant buffers are ``[mig_cap,
F]``), so the receiver sizes its buffers from its own.  Any dtype
travels, bool included, as the bytes of its tensor.
"""

import time

import torch

#: since :func:`reset_stats`: host syncs made to stage messages and
#: maxima through host memory, the messages and bytes sent to other
#: processes, and host seconds: ``sync_seconds`` waiting for the device
#: to finish a stage and its copies to the host, ``seconds`` the rest of
#: the cross-process exchanges (packing, sending, waiting for the peers'
#: messages, unpacking); ``local_messages`` and ``local_bytes``, the
#: messages delivered between two shards of this process (one a key a
#: receiving shard, the bytes of its tensors, whether a copy between
#: devices or a view on a shared one); ``steps``, the decomposed steps
#: taken (:meth:`Exchange.count_step`)
stats = {"host_syncs": 0, "messages": 0, "bytes": 0, "seconds": 0.0,
         "sync_seconds": 0.0, "local_messages": 0, "local_bytes": 0,
         "steps": 0}

_ALIGN = 16  # bytes; every message starts aligned in its buffer


def reset_stats():
    for key in stats:
        stats[key] = type(stats[key])()


def _tensors(value):
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _to_one(t, device):
    if t.device != device:
        # one peer copy of the message's bytes, not a kernel that reads a
        # strided view across the link
        t = t.contiguous()
    return t.to(device, non_blocking=True)


def _to(value, device):
    if isinstance(value, (list, tuple)):
        return [_to_one(t, device) for t in value]
    return _to_one(value, device)


def _nbytes(t):
    n = t.numel() * t.element_size()
    return n + (-n) % _ALIGN


def _pack(tensors):
    """One uint8 buffer holding the bytes of every tensor, each padded to
    :data:`_ALIGN`, on the first tensor's device."""
    dev = tensors[0].device
    parts = []
    for t in tensors:
        b = t.detach().to(dev).contiguous().reshape(-1).view(torch.uint8)
        pad = _nbytes(t) - b.numel()
        parts.append(b)
        if pad:
            parts.append(b.new_zeros(pad))
    return torch.cat(parts)


def _unpack(buf, likes):
    """The tensors shaped as ``likes`` whose bytes ``buf`` holds."""
    out, off = [], 0
    for like in likes:
        n = like.numel() * like.element_size()
        out.append(buf[off:off + n].view(like.dtype).view(like.shape))
        off += _nbytes(like)
    return out


class Exchange:
    """The exchanges of the decomposed steps over ``mesh``.

    Calling it runs one stage (:meth:`__call__`); :meth:`allreduce_max`
    meets the shards' maxima.  On a mesh that one process drives it
    copies between devices and never calls ``torch.distributed``.
    """

    def __init__(self, mesh):
        self.devices = tuple(mesh.devices)
        self.owners = tuple(mesh.owners)
        self.rank = mesh.rank
        self.local = mesh.local
        self.size = len(self.devices)
        self.spans_processes = any(o != self.rank for o in self.owners)
        self._direct = False
        if self.spans_processes:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "a mesh over several processes needs "
                    "torch.distributed.init_process_group")
            self._direct = dist.get_backend() == "nccl"

    def __call__(self, outgoing, routes):
        """One stage.

        Args:
            outgoing: one entry a shard of this process, in mesh order
                (:attr:`local`): ``{key: tensor or list of tensors}``,
                what the shard sends under each key.
            routes: one entry a shard of the whole mesh, ``{key: source
                shard or None}``: shard ``d`` receives
                ``outgoing[src][key]`` under ``key``.  Every process
                passes the same routes.

        Returns:
            One entry a shard of this process: ``{key: the received
            tensor(s) on the shard's device, or None where the route has
            no source}``.
        """
        sent = dict(zip(self.local, outgoing))
        out = {d: {} for d in self.local}
        sends, recvs = {}, {}
        for d in range(self.size):
            mine = self.owners[d] == self.rank
            for key, src in routes[d].items():
                if src is None:
                    if mine:
                        out[d][key] = None
                    continue
                theirs = self.owners[src] == self.rank
                if mine and theirs:
                    msg = sent[src][key]
                    out[d][key] = _to(msg, self.devices[d])
                    stats["local_messages"] += 1
                    stats["local_bytes"] += sum(
                        t.numel() * t.element_size() for t in _tensors(msg))
                elif theirs:
                    sends.setdefault(self.owners[d], []).extend(
                        _tensors(sent[src][key]))
                elif mine:
                    recvs.setdefault(self.owners[src], []).append(
                        (d, key, sent[d][key]))
        if sends or recvs:
            self._messages(sends, recvs, out)
        return [out[d] for d in self.local]

    def _messages(self, sends, recvs, out):
        """Post one buffer to each peer in ``sends`` and one receive from
        each in ``recvs`` (both in the order of the stage's routes), wait,
        and place what arrived in ``out``."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        ops, staged = [], False
        for peer in sorted(sends):
            buf = _pack(sends[peer])
            if buf.is_cuda and not self._direct:
                host = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=True)
                host.copy_(buf, non_blocking=True)
                buf, staged = host, True
            ops.append(dist.P2POp(dist.isend, buf, peer))
            stats["messages"] += 1
            stats["bytes"] += buf.numel()
        if staged:
            # Gloo reads the host buffers from its own threads
            t_sync = time.perf_counter()
            torch.cuda.current_stream().synchronize()
            stats["host_syncs"] += 1
            stats["sync_seconds"] += time.perf_counter() - t_sync
            t0 += time.perf_counter() - t_sync
        received = {}
        for peer in sorted(recvs):
            likes = [t for _d, _k, v in recvs[peer] for t in _tensors(v)]
            dev = self.devices[recvs[peer][0][0]]
            n = sum(_nbytes(t) for t in likes)
            if dev.type == "cuda" and self._direct:
                buf = torch.empty(n, dtype=torch.uint8, device=dev)
            else:
                buf = torch.empty(n, dtype=torch.uint8,
                                  pin_memory=dev.type == "cuda")
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            received[peer] = (buf, dev, likes)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for peer, (buf, dev, likes) in received.items():
            parts = iter(_unpack(buf.to(dev, non_blocking=True), likes))
            for d, key, like in recvs[peer]:
                if isinstance(like, (list, tuple)):
                    got = [next(parts) for _ in like]
                else:
                    got = next(parts)
                out[d][key] = _to(got, self.devices[d])
        stats["seconds"] += time.perf_counter() - t0

    def count_step(self):
        """Count one decomposed step in :data:`stats` (``steps``)."""
        stats["steps"] += 1

    def allreduce_max(self, values):
        """The elementwise largest of ``values`` (one tensor of one shape
        a shard of this process) over every shard of the mesh, on this
        process's first shard's device; the same on every process."""
        dev0 = self.devices[self.local[0]]
        m = torch.amax(torch.stack([v.to(dev0, non_blocking=True)
                                    for v in values]), dim=0)
        if not self.spans_processes:
            return m
        import torch.distributed as dist

        t0 = time.perf_counter()
        if m.is_cuda and not self._direct:
            host = m.cpu()
            stats["host_syncs"] += 1
            stats["sync_seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            dist.all_reduce(host, op=dist.ReduceOp.MAX)
            m = host.to(dev0, non_blocking=True)
        else:
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
        stats["seconds"] += time.perf_counter() - t0
        return m
