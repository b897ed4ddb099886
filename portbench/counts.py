"""The work a step's pair passes need, reckoned from the particles.

Pairs are the ordered pairs of particles closer than the support (each
particle with itself included), found by the neighbour search of the
configuration's reference; operations are pairs times the float32
operations of one pair term (``chip_smoke.py``'s ``FLOP_PER_PAIR``);
bytes are each particle's input fields read once and each output field
written once.
Nothing here reads the program's layout (tiers, slots, capacity) or its
launches, so a change of layout or kernel leaves the yardstick where it
is.
"""

from . import reference
from .inputs import sample_rows

#: float32 operations per pair within the support, by pass
FLOP_PER_PAIR = {"density": 19, "accel": 38, "accel_drho": 48,
                 "accel_xsph": 54, "accel_drho_xsph": 64, "energy": 34,
                 "st_normals": 21, "st_force": 20}
#: bytes a particle reads and writes in one pass, as float32 fields in
#: and out: density x -> rho; the momentum passes x, v, rho, p -> acc
#: (12), with drho/dt (4) and the XSPH velocity (12) where they have
#: them; energy x, v, rho, p -> du/dt; the surface tension's normals
#: x, rho -> n, and its force x, n, rho -> acc
BYTES_PER_PARTICLE = {"density": (12, 4), "accel": (32, 12),
                      "accel_drho": (32, 16), "accel_xsph": (32, 24),
                      "accel_drho_xsph": (32, 28), "energy": (32, 4),
                      "st_normals": (16, 12), "st_force": (28, 12)}
#: published peaks of one NVIDIA H100 SXM: float32 outside the tensor
#: cores and HBM3 bandwidth
PEAK_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def pairs_in_support(x, cfg, rows="all", seed=0):
    """Ordered pairs within the support of ``x`` (``[N, 3]``); with a
    row count, counted for that many rows drawn from the seed and scaled
    to all ``N`` particles."""
    plain = reference.load(cfg["reference"])
    params = plain.Params(cfg)
    n = x.shape[0]
    query = sample_rows(n, rows, seed, x.device)
    binning = plain.Binning(x, params)
    total = 0
    for qi, _ in plain.pairs_within(query, x, binning, params.support):
        total += int(qi.numel())
    return total * n / query.numel()


def work_per_step(x, cfg, seed=0):
    """``{"pairs", "flop", "bytes"}`` the configuration's pair passes
    need in one step from the positions ``x``."""
    passes = cfg["pair_passes"]
    pairs = pairs_in_support(x, cfg, cfg.get("count_rows", "all"), seed)
    n = x.shape[0]
    flop = pairs * sum(FLOP_PER_PAIR[p] for p in passes)
    n_bytes = n * sum(sum(BYTES_PER_PARTICLE[p]) for p in passes)
    return {"pairs": pairs, "flop": flop, "bytes": n_bytes}


def bound_s(work):
    """The roofline bound of the work: the longer of its operations at
    the float32 peak and its bytes at the HBM bandwidth."""
    return max(work["flop"] / PEAK_FLOP_S, work["bytes"] / PEAK_BYTES_S)

