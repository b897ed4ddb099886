"""The device meshes of the decomposed SPH steps (torch counterpart of
``tpgsd.parallel.mesh``: ``make_mesh``, ``make_mesh2d`` and
``make_mesh3d``).

The reference's decompositions run the step body on every device of a
``jax.sharding.Mesh`` through ``shard_map`` and exchange halos with
``lax.ppermute``.  In the port one Python process drives every shard of
a :class:`Mesh` it owns, a tuple of ``torch.device``; an exchange
between two of its shards is a copy to the neighbour's device, and
between processes a message (:mod:`tpgsd_torch.parallel.exchange`).  A
device may repeat, so one GPU holds several shards
(``make_mesh(devices=["cuda:0"] * 2)``), and so do the CPU tests
(``make_mesh(devices=["cpu"] * 4)``).

The reference's GSPMD helpers (``row_sharding``, ``pad_rows``,
``shard_rows``) place one array across devices for the compiler; torch
has no such placement, so they have no counterpart.

A block mesh (:func:`make_mesh2d`, :func:`make_mesh3d`) is the same
tuple of devices with a ``shape``: block ``(i, j)`` of a ``(px, py)``
mesh is shard ``i * py + j`` (C order, as the reference's ``reshape``
of its device list).

With ``comm=`` (a :class:`~tpgsd_torch.parallel.comm.TorchProcessComm`)
the mesh spans processes, as the reference's does under
``jax.distributed``: each process names its own devices, and the mesh is
their allgather in rank order (the order of the reference's
``jax.devices()`` across processes).  ``owners[d]`` is the rank that
drives shard ``d``, and :attr:`Mesh.local` lists this process's shards.
"""

from typing import NamedTuple

import numpy as np
import torch


class _MeshFields(NamedTuple):
    devices: tuple  # of torch.device, one a shard
    shape: tuple  # the block shape; (len(devices),) for a 1-D mesh
    owners: tuple  # the rank of the process that drives each shard
    rank: int  # this process's rank


class Mesh(_MeshFields):
    """A mesh of shards: shard ``d`` lives on ``devices[d]``, at block
    ``numpy.unravel_index(d, shape)``, driven by process ``owners[d]``.
    ``shape`` defaults to ``(len(devices),)``, the 1-D mesh of the slab
    step; ``owners`` to every shard on this process (``rank`` 0)."""

    __slots__ = ()

    def __new__(cls, devices, shape=None, owners=None, rank=0):
        devices = tuple(devices)
        shape = (len(devices),) if shape is None else tuple(
            int(s) for s in shape)
        if int(np.prod(shape)) != len(devices):
            raise ValueError("a mesh of shape %s needs %d devices, got %d"
                             % (shape, int(np.prod(shape)), len(devices)))
        owners = (int(rank),) * len(devices) if owners is None else tuple(
            int(o) for o in owners)
        if len(owners) != len(devices):
            raise ValueError("%d owners for %d shards"
                             % (len(owners), len(devices)))
        return super().__new__(cls, devices, shape, owners, int(rank))

    @property
    def size(self):
        return len(self.devices)

    @property
    def local(self):
        """The shards this process drives, in mesh order."""
        return tuple(d for d, o in enumerate(self.owners) if o == self.rank)


def _device(d):
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _over(comm, devs, shape=None):
    """The :class:`Mesh` of ``shape`` over this process's ``devs`` alone,
    or with a ``comm`` of several processes, over every process's devices
    in rank order (each process keeps its own device objects); the
    devices are cut to the shape's product."""
    devices, owners, rank = list(devs), None, 0
    if comm is not None and comm.size > 1:
        devices, owners, rank = [], [], comm.rank
        for r, names in enumerate(comm.allgather([str(d) for d in devs])):
            devices += list(devs) if r == rank else [torch.device(n)
                                                     for n in names]
            owners += [r] * len(names)
    n = len(devices) if shape is None else int(np.prod(shape))
    return Mesh(devices=devices[:n], shape=shape,
                owners=None if owners is None else owners[:n], rank=rank)


def make_mesh(n_devices=None, devices=None, comm=None):
    """A 1-D :class:`Mesh` of ``n_devices`` shards.

    By default the shards are every visible CUDA device, one each, or
    the first ``n_devices`` of them; asking for more than are visible
    raises ``ValueError``, as the reference does, and with no visible GPU
    the call raises ``RuntimeError``: there is no silent CPU mesh.
    ``devices`` names the device of each shard instead (strings or
    ``torch.device``, repeats allowed: ``["cuda:0"] * 2`` puts two
    shards on one GPU, ``["cpu"] * 4`` four on the CPU); ``n_devices``
    must then be ``None`` or its length.

    With ``comm`` (a :class:`~tpgsd_torch.parallel.comm.TorchProcessComm`)
    ``n_devices`` and ``devices`` name this process's shards, and the mesh
    is every process's, in rank order (a collective call).
    """
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh(devices=...) needs at least one device")
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(
                "make_mesh(n_devices=%d) got %d devices"
                % (int(n_devices), len(devs))
            )
        return _over(comm, devs)
    gpus = _visible_gpus("make_mesh")
    if n_devices is not None and len(gpus) < int(n_devices):
        raise ValueError(
            "make_mesh(n_devices=%d): only %d CUDA device(s) available "
            "(several shards share one device with devices=['cuda:0'] * %d)"
            % (int(n_devices), len(gpus), int(n_devices))
        )
    n = len(gpus) if n_devices is None else int(n_devices)
    return _over(comm, gpus[:n])


def _visible_gpus(name):
    if not torch.cuda.is_available():
        raise RuntimeError(
            "%s() places its shards on the visible CUDA devices and sees "
            "none; pass devices=[...] (e.g. ['cpu'] * 4) to build a mesh "
            "elsewhere" % name
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _block_mesh(name, shape, devices, default_shape, comm):
    devs = (_visible_gpus(name) if devices is None
            else [_device(d) for d in devices])
    total = (len(devs) if comm is None
             else sum(comm.allgather(len(devs))))
    shape = default_shape(total) if shape is None else tuple(
        int(s) for s in shape)
    n = int(np.prod(shape))
    if n < 1 or total < n:
        raise ValueError("%s(shape=%s) needs %d devices, got %d"
                         % (name, shape, n, total))
    return _over(comm, devs, shape)


def _square(n):
    """The reference's most-square factorisation: 8 -> (4, 2)."""
    px = int(np.sqrt(n))
    while n % px != 0:
        px -= 1
    return (max(px, n // px), min(px, n // px))


def _cubic(n):
    """The reference's most-cubic factorisation: 8 -> (2, 2, 2)."""
    px = max(d for d in range(1, int(round(n ** (1 / 3))) + 1) if n % d == 0)
    py, pz = _square(n // px)
    return tuple(sorted((px, py, pz), reverse=True))


def make_mesh2d(shape=None, devices=None, comm=None):
    """A 2-D block :class:`Mesh` ``(px, py)`` for
    :func:`tpgsd_torch.sph.make_distributed2d_step_fn`.

    ``devices`` (strings or ``torch.device``, repeats allowed) default to
    every visible CUDA device; with no visible GPU the call raises
    ``RuntimeError``.  ``shape`` defaults to the most-square
    factorisation of their count (8 -> ``(4, 2)``); the devices are cut
    to the shape's product, as the reference's ``devices[: px * py]``.
    With ``comm``, ``devices`` are this process's and the mesh is every
    process's, as :func:`make_mesh`'s (the count and the cut over all of
    them).
    """
    return _block_mesh("make_mesh2d", shape, devices, _square, comm)


def make_mesh3d(shape=None, devices=None, comm=None):
    """A 3-D block :class:`Mesh` ``(px, py, pz)`` for
    :func:`tpgsd_torch.sph.make_distributed3d_step_fn`: as
    :func:`make_mesh2d`, the default shape the most-cubic factorisation
    of the device count (8 -> ``(2, 2, 2)``)."""
    return _block_mesh("make_mesh3d", shape, devices, _cubic, comm)
