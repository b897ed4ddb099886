#!/usr/bin/env python3
"""End-to-end demo of the PyTorch/CUDA port: a WCSPH simulation with
trajectory dumps from inside the rollout.

The single-device twin of ``examples/dam_break_demo.py``: the same
scenarios (3-D dam break, planar 2-D dam break, periodic Taylor-Green
vortex, hydrostatic tank with fixed floor particles) and step options,
stepped by ``tpgsd_torch`` on one device (``--device``, the card by
default) through ``scan_simulate`` / ``scan_simulate_adaptive``, with
every Nth frame streamed to a hoomd-schema GSD file by the port's async
writer; prints throughput stats and (optionally) converts the result to
VTK point clouds.

    python examples/dam_break_demo_torch.py --adaptive --steps 200 --every 10
    python examples/dam_break_demo_torch.py --scenario taylor_green --steps 300
    python examples/dam_break_demo_torch.py --device cpu --n-side 6 --steps 20
    python examples/dam_break_demo_torch.py --decomp slab --shards 2
    python examples/dam_break_demo_torch.py --decomp 3d --shards 8

``--decomp slab`` steps the slab domain decomposition
(``tpgsd_torch.sph.make_distributed_step_fn``), ``--decomp 2d`` / ``3d``
the block decompositions (``make_distributed2d_step_fn`` /
``make_distributed3d_step_fn``) on the block shape the JAX demo fits to
``--shards`` (the most shards the grid divides, then the most balanced
shape; a count no shape uses whole raises ``ValueError``).  Every shard
is placed on ``--device`` (on a one-GPU machine the shards share
``cuda:0``), and frames go through ``collect_state`` / ``collect_aux``
as the JAX demo does.  The JAX demo's ``--sharded`` is not offered: the
GSPMD sharding hint has no counterpart.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--every", type=int, default=5, help="dump cadence")
    p.add_argument("--n-side", type=int, default=14)
    p.add_argument(
        "--scenario",
        default="dam_break",
        choices=["dam_break", "dam_break_2d", "taylor_green", "hydrostatic"],
        help="which flow to run (taylor_green runs with periodic "
             "boundaries; hydrostatic uses fixed floor particles)",
    )
    p.add_argument("--out", default=None,
                   help="output file (default <scenario>.gsd)")
    p.add_argument("--device", default="cuda",
                   help="where the state lives and the step runs (default "
                        "cuda; cpu runs the plain pair passes)")
    p.add_argument("--on-device", action="store_true",
                   help="build the dam_break lattice on the device")
    p.add_argument("--vtu", action="store_true", help="convert to .vtu after")
    p.add_argument("--adaptive", action="store_true",
                   help="CFL-adaptive dt (Monaghan force/Courant "
                        "controller; dt stays a device tensor, so the "
                        "rollout never waits for the card)")
    p.add_argument("--cfl", type=float, default=0.25,
                   help="safety factor for --adaptive (default 0.25)")
    p.add_argument("--xsph", type=float, default=0.0,
                   help="XSPH drift-smoothing strength (e.g. 0.5)")
    p.add_argument("--surface-tension", type=float, default=0.0,
                   help="strength gamma of the Akinci surface-tension "
                        "model (cohesion + curvature, momentum-exact; "
                        "drops contract and merge)")
    p.add_argument("--density-renorm", action="store_true",
                   help="free-surface density floor (no negative "
                        "surface pressures)")
    p.add_argument("--density-mode", choices=["summation", "continuity"],
                   default="summation",
                   help="density formulation: continuity evolves rho as "
                        "carried state (one fused accel+drho sweep)")
    p.add_argument("--spill", action="store_true",
                   help="two-tier spill cell layout (main tier sized at "
                        "1.15x the densest initial cell, clamped to 24-64)")
    p.add_argument("--decomp", choices=["slab", "2d", "3d"], default=None,
                   help="explicit domain decomposition with halo exchange "
                        "and migration: x-slabs (make_distributed_step_fn) "
                        "or 2-D / 3-D blocks (make_distributed2d_step_fn, "
                        "make_distributed3d_step_fn)")
    p.add_argument("--shards", type=int, default=2,
                   help="shards of --decomp, all on --device (slab: a "
                        "divisor of the grid's x cells; 2d/3d: a count "
                        "some block shape of the grid uses whole; "
                        "default 2)")
    args = p.parse_args(argv)

    import numpy
    import torch

    import tpgsd_torch.hoomd
    from tpgsd_torch.io_runtime import (
        JitDumpChannel,
        scan_simulate,
        scan_simulate_adaptive,
    )
    from tpgsd_torch.parallel import (
        ShardedFrameWriter,
        SingleComm,
        make_mesh,
        make_mesh2d,
        make_mesh3d,
    )
    from tpgsd_torch.sph import (
        collect_aux,
        collect_state,
        dam_break,
        dam_break_2d,
        distribute_state,
        distribute_state_2d,
        distribute_state_3d,
        hydrostatic_tank,
        init_density,
        make_adaptive_distributed2d_step_fn,
        make_adaptive_distributed3d_step_fn,
        make_adaptive_distributed_step_fn,
        make_adaptive_step_fn,
        make_distributed2d_step_fn,
        make_distributed3d_step_fn,
        make_distributed_step_fn,
        make_step_fn,
        taylor_green,
    )

    dev = args.device
    if args.on_device and args.scenario != "dam_break":
        raise SystemExit("--on-device builds the dam_break lattice only")
    periodic = args.scenario == "taylor_green"
    n_fixed = 0
    if args.scenario == "dam_break":
        db = dam_break(
            n_side=args.n_side, capacity="auto",
            capacity_headroom=1.15 if args.spill else 1.5,
            device=dev, on_device=args.on_device,
        )
    elif args.scenario == "dam_break_2d":
        db = dam_break_2d(n_side=args.n_side, capacity="auto", device=dev)
    elif args.scenario == "taylor_green":
        db = taylor_green(n_side=max(args.n_side, 12), device=dev)
    else:
        db = hydrostatic_tank(n_side=args.n_side, device=dev)
        n_fixed = db.n_fixed
    if args.spill:
        # tiny demo domains stretch cells (occupancy above the packed
        # range); clamp the MAIN tier - the spill tier still holds 2K
        cap = min(max(db.grid.capacity, 24), 64)
        db = db._replace(grid=db.grid._replace(capacity=cap))
    if args.out is None:
        args.out = args.scenario + ".gsd"
    box3 = tuple(db.box) + (0.0,) * (3 - len(db.box))
    print("scenario: %s  particles: %d  grid: %s cells  dt: %.2e"
          % (args.scenario, db.n, db.grid.dims, db.params.dt))

    state = db.state
    if args.density_mode == "continuity":
        state = init_density(state, db.grid, db.params, periodic=periodic,
                             device=dev)
    kw = dict(
        n_fixed=n_fixed, periodic=periodic,
        xsph=args.xsph, density_renorm=args.density_renorm,
        surface_tension=args.surface_tension,
        spill=True if args.spill else "auto",
        density_mode=args.density_mode, device=dev,
    )
    if args.adaptive:
        kw["cfl"] = args.cfl
    decomp = args.decomp is not None
    shards = args.shards
    if args.decomp == "slab":
        nx = db.grid.dims[0]
        if shards < 1 or nx % shards:
            raise ValueError("--shards %d must divide the grid's %d x cells"
                             % (shards, nx))
        mesh = make_mesh(devices=[dev] * shards)
        distribute = distribute_state
        build = (make_adaptive_distributed_step_fn if args.adaptive
                 else make_distributed_step_fn)
    elif decomp:
        nd = 2 if args.decomp == "2d" else 3
        shape = _fit_mesh(db.grid.dims, nd, shards)
        if shards < 1 or math.prod(shape) != shards:
            raise ValueError(
                "--shards %d: no %s block shape of the grid's %s cells uses "
                "them all (the best is %s)"
                % (shards, args.decomp, db.grid.dims, shape))
        make = make_mesh2d if nd == 2 else make_mesh3d
        mesh = make(shape=shape, devices=[dev] * shards)
        distribute = distribute_state_2d if nd == 2 else distribute_state_3d
        if args.adaptive:
            build = (make_adaptive_distributed2d_step_fn if nd == 2
                     else make_adaptive_distributed3d_step_fn)
        else:
            build = (make_distributed2d_step_fn if nd == 2
                     else make_distributed3d_step_fn)
    if decomp:
        del kw["device"]
        state, cap = distribute(state, db.grid, mesh)
        step = build(db.grid, db.params, mesh, capacity=cap, **kw)
        print("decomposed (%s) over %d shards on %s, %s%d slots a shard"
              % (args.decomp, shards, dev, "" if args.decomp == "slab"
                 else "block shape %s, " % (mesh.shape,), cap))
    else:
        build = make_adaptive_step_fn if args.adaptive else make_step_fn
        step = build(db.grid, db.params, **kw)
    print("device %s (resolved: %s)" % (dev, step.resolved))

    writer = ShardedFrameWriter(
        args.out,
        comm=SingleComm(),
        static={
            "configuration/box": numpy.array(
                list(box3) + [0, 0, 0], numpy.float32
            ),
            "particles/N": numpy.array([db.n], numpy.uint32),
        },
    )
    if decomp:
        slength = numpy.full(db.n, db.params.h, numpy.float32)

        def frame_of(s, aux):
            # the compact global frame, gathered to the host in pid order
            xh, vh, _rho = collect_state(s, db.n)
            rho, pres, _du = collect_aux(s, aux, db.n, params=db.params)
            return [xh, vh, rho, pres, slength]
    else:
        slength = torch.full((db.n,), db.params.h, dtype=torch.float32,
                             device=dev)

        def frame_of(s, aux):
            rho, pres, _overflow = aux
            return [s.x, s.v, rho, pres, slength]

    channel = JitDumpChannel(
        writer,
        ["particles/" + c
         for c in ("position", "velocity", "density", "pressure", "slength")],
    )
    with channel:
        if args.adaptive:
            state, dt, t_sim = scan_simulate_adaptive(
                step, state, db.params.dt, args.steps, channel, frame_of,
                every=args.every,
            )
        else:
            state = scan_simulate(
                step, state, args.steps, channel, frame_of, every=args.every
            )

    if args.adaptive:
        print(
            "adaptive dt: simulated %.4f s in %d steps (fixed dt would "
            "cover %.4f s); final dt %.2e (seed %.2e)"
            % (float(t_sim), args.steps, args.steps * db.params.dt,
               float(dt), db.params.dt)
        )

    s = channel.stats
    print(
        "dumped %d frames, %.1f MB: writer %.1f MB/s, overlapped %.1f MB/s "
        "(overlap efficiency %.0f%%)"
        % (s.frames, s.bytes / 1e6, s.write_mb_s, s.effective_mb_s,
           100 * s.overlap_efficiency)
    )

    with tpgsd_torch.hoomd.open(args.out, mode="r") as traj:
        last = traj[-1]
        print(
            "trajectory: %d frames; last frame step=%d, max|v|=%.3f, "
            "rho in [%.0f, %.0f]"
            % (
                len(traj),
                last.configuration.step,
                float(numpy.abs(last.particles.velocity).max()),
                float(last.particles.density.min()),
                float(last.particles.density.max()),
            )
        )

    if args.vtu:
        from tpgsd_torch.vtu import convert

        written = convert(args.out, quiet=True)
        print("wrote %d .vtu files" % len(written))


def _fit_mesh(dims, nd, n_shards):
    """The JAX demo's block shape (examples/dam_break_demo.py:165-190):
    the most of ``n_shards`` used (each factor dividing its grid axis),
    then the most balanced."""
    best = [(1,) * nd]

    def key(shape):
        return (math.prod(shape), -sum(shape))

    def rec(ax, rem, cur):
        if ax == nd:
            if key(cur) > key(best[0]):
                best[0] = tuple(cur)
            return
        for d in range(1, rem + 1):
            if rem % d == 0 and dims[ax] % d == 0:
                rec(ax + 1, rem // d, cur + [d])

    rec(0, n_shards, [])
    return best[0]


if __name__ == "__main__":
    main()
