"""Time the port's pair kernels on one NVIDIA GPU.

    python /path/to/tools/torch_pair_kernel_times.py [--reps 20] [--ks 32,24]
        [--tiles 4,7] [--wide [--no-bound]] [--steps [--layout wide]]

Run from the root of a checkout: the checkout's ``tpgsd_torch`` and
``chip_smoke.py`` are the code timed, so two checkouts (a change and its
parent) can be timed in turns in one call on one card.  Inputs are those
of ``chip_smoke.py`` phase 6: the jittered 1M dam break at K = 32 (the
spill tier empty) and at K = 24 (24,298 particles in it).  Prints one
line per role and pass: device ms (CUDA events over ``--reps`` launches
after warm-up) beside the roofline bound of ``chip_smoke.roofline``, and
with ``--tiles`` the tile kernels at each forced tile size.  With
``--wide`` it times the single-tier roles past 64 slots instead
(``density_wide``, ``accel_wide``, ``accel_drho_wide``) on the jittered
1M dam break at each K of ``--ks`` (default 128), ``--tiles`` forcing
each role's T and ``--no-bound`` skipping the bound (its pair
count grows as K squared).  With ``--steps`` it times the 1M step of
``--layout`` (``spill``, ``wide``, ``periodic spill`` or ``periodic
wide``; the periodic layouts on the 1M still box) instead, in both
density modes (``chip_smoke.step_ms`` over ``--reps`` steps, then the
profile of ``chip_smoke.phase_profile``: device busy time, idle share,
time by layer).  Imports nothing of JAX.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from tpgsd_torch.sph import WendlandC2, dam_break, ops  # noqa: E402

LAYOUTS = ("spill", "wide", "periodic spill", "periodic wide")


def time_steps(args, dev, card, where):
    """The 1M step of ``args.layout`` in both density modes."""
    n_side = cs.N_BOX_1M if args.layout.startswith("periodic") else cs.N_1M
    for mode in ("summation", "continuity"):
        step, state = cs.configuration(args.layout, n_side, dev, mode)
        print("%s: %s %s N=%d: %.4f ms/step [%s]" % (
            where, args.layout, mode, state.x.shape[0],
            cs.step_ms(step, state, args.reps, 3), card))
        del step, state
        cs.phase_profile(dev, card, args.layout, n_side, mode)
        sys.stdout.flush()


def time_wide(args, dev, card, where, tiles):
    """The single-tier roles past 64 slots on the 1M dam break."""
    for k in (int(k) for k in (args.ks or "128").split(",")):
        db = dam_break(n_side=cs.N_1M, capacity=k, device=dev)
        params = db.params
        grid, x, v, m = cs.single_tier_inputs(db, k, dev)
        tier = (x, v, *cs.finish_density(ops.density(x, m, grid, params), m,
                                          params), m)
        folded = (tier[:3] + (ops.pressure_plane(tier[2], tier[3], params),)
                  + tier[4:])

        def accel(delta_sph):
            return lambda tile=None: ops._launch_accel(
                *folded, *folded, grid, params, WendlandC2, "self", delta_sph,
                tile)

        launches = {
            "density": (1, lambda tile=None: ops._launch_density(
                x, m, x, m, grid, params, WendlandC2, "self", tile)),
            "accel": (3, accel(None)),
            "accel_drho": (4, accel(cs.DELTA_SPH)),
        }
        for family, (n_out, kern) in launches.items():
            ms = cs.cuda_ms(kern, args.reps, 3)
            bound = ""
            if not args.no_bound:
                b, by, _, _ = cs.roofline(family, tier, tier, grid, params,
                                          WendlandC2, n_out)
                bound = ", bound %.4f ms by %s" % (b, by)
            extra = "".join(
                ", T=%d %.4f" % (t, cs.cuda_ms(lambda: kern(t), args.reps, 3))
                for t in tiles)
            print("%s: %s_wide K=%d (%d live of %d slots): %.4f ms%s%s [%s]"
                  % (where, family, k, int(m.sum()), m.numel(), ms, bound,
                     extra, card))
            sys.stdout.flush()
        del db, grid, x, v, m, tier, folded, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ks", default=None,
                    help="comma-separated capacities: 32 (the spill tier "
                    "empty) and 24 (occupied) by default; with --wide, "
                    "capacities past 64 (default 128)")
    ap.add_argument("--tiles", default="",
                    help="comma-separated tile sizes to force (tile kernels)")
    ap.add_argument("--wide", action="store_true",
                    help="time the single-tier roles past 64 slots instead")
    ap.add_argument("--no-bound", action="store_true",
                    help="with --wide: skip the roofline bound")
    ap.add_argument("--steps", action="store_true",
                    help="time and profile the 1M step of --layout instead")
    ap.add_argument("--layout", default="spill", choices=LAYOUTS,
                    help="with --steps: the layout of the step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    tiles = [int(t) for t in args.tiles.split(",") if t]
    where = os.path.basename(os.getcwd())
    if args.steps:
        time_steps(args, dev, card, where)
        return
    if args.wide:
        time_wide(args, dev, card, where, tiles)
        return
    db = dam_break(n_side=cs.N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    params = db.params
    for k in (int(k) for k in (args.ks or "32,24").split(",")):
        s = cs.spill_inputs(db, k, dev)
        grid, a, b = s["grid"], s["a"], s["b"]
        names = {id(a): "A", id(b): "B"}
        passes = ((a, a), (a, b)) if k == 32 else ((a, a), (a, b), (b, a),
                                                   (b, b))
        for family, (n_out, kern, _) in cs.pair_passes(
                a, b, grid, params).items():
            for cen, nbr in passes:
                role = "self" if nbr is cen else "cross"
                ms = cs.cuda_ms(lambda: kern(cen, nbr, role), args.reps, 3)
                bound, by, _, _ = cs.roofline(family, cen, nbr, grid, params,
                                              WendlandC2, n_out)
                extra = "".join(
                    ", T=%d %.4f" % (t, cs.cuda_ms(
                        lambda: kern(cen, nbr, role, t), args.reps, 3))
                    for t in tiles)
                print("%s: %s_%s K=%d %s <- %s: %.4f ms, bound %.4f ms by %s"
                      "%s [%s]" % (where, family, role, k, names[id(cen)],
                                   names[id(nbr)], ms, bound, by, extra, card))
                sys.stdout.flush()
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
