"""The inputs of a run, made from ``--seed`` by the benchmark itself.

The dam break's lattice, particle ``i`` at ``(idx + 0.5) * spacing`` of
the x-major block, made on the run's device, jittered by
``jitter * spacing`` times a standard normal drawn from a generator
seeded with the run's seed; velocities at rest.  Nothing else depends
on the seed, so every seed gives the same particle count, grid and
amount of work up to the jitter.
"""

import numpy as np
import torch


def generator(seed, device, stream=0):
    """A generator on ``device`` for the seed's stream ``stream`` (0 the
    jitter, 1 the sampled rows)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), stream])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    return g


def lattice(cfg, seed, device):
    """``(x, v)`` float32 ``[N, 3]`` on ``device``."""
    sc = cfg["scenario"]
    cx, cy, cz = sc["lattice"]
    dx = float(sc["spacing"])
    n = cx * cy * cz
    i = torch.arange(n, dtype=torch.int64, device=device)
    ix = i // (cy * cz)
    rem = i - ix * (cy * cz)
    iy = rem // cz
    iz = rem - iy * cz
    x = torch.stack([ix, iy, iz], dim=1).to(torch.float32)
    del i, ix, rem, iy, iz
    x.add_(0.5).mul_(dx)
    noise = torch.randn(x.shape, generator=generator(seed, device),
                        device=device, dtype=torch.float32)
    x.add_(noise.mul_(float(sc["jitter"]) * dx))
    return x, torch.zeros_like(x)


def sample_rows(n, count, seed, device):
    """``count`` distinct particle indices drawn from the seed (all of
    them, in order, when ``count`` is ``"all"`` or at least ``n``)."""
    if count == "all" or int(count) >= n:
        return torch.arange(n, device=device)
    g = generator(seed, "cpu", stream=1)
    rows = torch.randint(0, n, (2 * int(count),), generator=g)
    rows = torch.unique(rows)
    rows = rows[torch.randperm(rows.numel(), generator=g)[:int(count)]]
    return torch.sort(rows).values.to(device)
