"""The device meshes of the decomposed SPH steps (torch counterpart of
``tpgsd.parallel.mesh``: ``make_mesh``, ``make_mesh2d`` and
``make_mesh3d``).

The reference's decompositions are single-controller: one process runs
the step body on every device of a 1-D ``jax.sharding.Mesh`` through
``shard_map`` and exchanges halos with ``lax.ppermute``.  The port keeps
that design: one Python process drives every shard of a :class:`Mesh`,
a tuple of ``torch.device``, and an exchange is a copy to the
neighbour's device.  A device may repeat, so one GPU holds several
shards (``make_mesh(devices=["cuda:0"] * 2)``), and so do the CPU tests
(``make_mesh(devices=["cpu"] * 4)``).

The reference's GSPMD helpers (``row_sharding``, ``pad_rows``,
``shard_rows``) place one array across devices for the compiler; torch
has no such placement, so they have no counterpart.

A block mesh (:func:`make_mesh2d`, :func:`make_mesh3d`) is the same
tuple of devices with a ``shape``: block ``(i, j)`` of a ``(px, py)``
mesh is shard ``i * py + j`` (C order, as the reference's ``reshape``
of its device list).
"""

from typing import NamedTuple

import numpy as np
import torch


class _MeshFields(NamedTuple):
    devices: tuple  # of torch.device, one a shard
    shape: tuple  # the block shape; (len(devices),) for a 1-D mesh


class Mesh(_MeshFields):
    """A mesh of shards: shard ``d`` lives on ``devices[d]``, at block
    ``numpy.unravel_index(d, shape)``.  ``shape`` defaults to
    ``(len(devices),)``, the 1-D mesh of the slab step."""

    __slots__ = ()

    def __new__(cls, devices, shape=None):
        devices = tuple(devices)
        shape = (len(devices),) if shape is None else tuple(
            int(s) for s in shape)
        if int(np.prod(shape)) != len(devices):
            raise ValueError("a mesh of shape %s needs %d devices, got %d"
                             % (shape, int(np.prod(shape)), len(devices)))
        return super().__new__(cls, devices, shape)

    @property
    def size(self):
        return len(self.devices)


def _device(d):
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices=None, devices=None):
    """A 1-D :class:`Mesh` of ``n_devices`` shards.

    By default the shards are every visible CUDA device, one each, or
    the first ``n_devices`` of them; asking for more than are visible
    raises ``ValueError``, as the reference does, and with no visible GPU
    the call raises ``RuntimeError``: there is no silent CPU mesh.
    ``devices`` names the device of each shard instead (strings or
    ``torch.device``, repeats allowed: ``["cuda:0"] * 2`` puts two
    shards on one GPU, ``["cpu"] * 4`` four on the CPU); ``n_devices``
    must then be ``None`` or its length.
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
        return Mesh(devices=devs)
    gpus = _visible_gpus("make_mesh")
    if n_devices is not None and len(gpus) < int(n_devices):
        raise ValueError(
            "make_mesh(n_devices=%d): only %d CUDA device(s) available "
            "(several shards share one device with devices=['cuda:0'] * %d)"
            % (int(n_devices), len(gpus), int(n_devices))
        )
    n = len(gpus) if n_devices is None else int(n_devices)
    return Mesh(devices=gpus[:n])


def _visible_gpus(name):
    if not torch.cuda.is_available():
        raise RuntimeError(
            "%s() places its shards on the visible CUDA devices and sees "
            "none; pass devices=[...] (e.g. ['cpu'] * 4) to build a mesh "
            "elsewhere" % name
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _block_mesh(name, shape, devices, default_shape):
    devs = (_visible_gpus(name) if devices is None
            else [_device(d) for d in devices])
    shape = default_shape(len(devs)) if shape is None else tuple(
        int(s) for s in shape)
    n = int(np.prod(shape))
    if n < 1 or len(devs) < n:
        raise ValueError("%s(shape=%s) needs %d devices, got %d"
                         % (name, shape, n, len(devs)))
    return Mesh(devices=devs[:n], shape=shape)


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


def make_mesh2d(shape=None, devices=None):
    """A 2-D block :class:`Mesh` ``(px, py)`` for
    :func:`tpgsd_torch.sph.make_distributed2d_step_fn`.

    ``devices`` (strings or ``torch.device``, repeats allowed) default to
    every visible CUDA device; with no visible GPU the call raises
    ``RuntimeError``.  ``shape`` defaults to the most-square
    factorisation of their count (8 -> ``(4, 2)``); the devices are cut
    to the shape's product, as the reference's ``devices[: px * py]``.
    """
    return _block_mesh("make_mesh2d", shape, devices, _square)


def make_mesh3d(shape=None, devices=None):
    """A 3-D block :class:`Mesh` ``(px, py, pz)`` for
    :func:`tpgsd_torch.sph.make_distributed3d_step_fn`: as
    :func:`make_mesh2d`, the default shape the most-cubic factorisation
    of the device count (8 -> ``(2, 2, 2)``)."""
    return _block_mesh("make_mesh3d", shape, devices, _cubic)
