"""The device mesh of the decomposed SPH step (torch counterpart of
``tpgsd.parallel.mesh.make_mesh``).

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
"""

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    """A 1-D mesh: shard ``d`` lives on ``devices[d]``."""

    devices: tuple  # of torch.device, one a shard

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
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() places its shards on the visible CUDA devices and "
            "sees none; pass devices=[...] (e.g. ['cpu'] * 4) to build a "
            "mesh elsewhere"
        )
    avail = torch.cuda.device_count()
    if n_devices is not None and avail < int(n_devices):
        raise ValueError(
            "make_mesh(n_devices=%d): only %d CUDA device(s) available "
            "(several shards share one device with devices=['cuda:0'] * %d)"
            % (int(n_devices), avail, int(n_devices))
        )
    n = avail if n_devices is None else int(n_devices)
    return Mesh(devices=tuple(torch.device("cuda", i) for i in range(n)))
