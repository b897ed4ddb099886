"""Smoke run of the tpgsd_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA pair kernels from ``tpgsd_torch/csrc`` (nvcc, first use),
holds each against its plain PyTorch version on the 1M-particle dam break,
drives the port's two main paths (the flagship spill step in summation
and in continuity density mode, each with its async GSD dump through the
port's own writer) for 20 steps, checks the written files and the kernel
launch counts, compares one step of each kernel path with its plain
path, times steps and kernels beside each kernel's roofline bound, and
profiles both steps at 100k and 1M particles (torch.profiler: the device
time per layer and the device's idle share, from one trace each).
Every phase raises on failure; the script exits non-zero and prints no
result line.  It needs a CUDA device and never runs on the CPU, and it
imports nothing of JAX or of the JAX package ``tpgsd``.

The second-to-last line of standard output is a JSON object with one
entry per kernel role; the last line is the run's result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import tpgsd_torch.hoomd
from tpgsd_torch import _build
from tpgsd_torch.entry import entry
from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm
from tpgsd_torch.sph import (
    CubicSpline,
    WendlandC2,
    dam_break,
    make_step_fn,
    ops,
)
from tpgsd_torch.sph.cells import build_cells_spill, scatter_to_cells_soa
from tpgsd_torch.sph.step import (
    _cell_blocks,
    _gather_nbr,
    _with_sentinel_cell,
    neighbor_index,
    tait_pressure,
)

N_1M = 86  # n_side of the 1,003,104-particle dam break
N_1M_PARTICLES = 1003104
N_100K = 40  # n_side of the 100,000-particle dam break
DELTA_SPH = 0.1  # make_step_fn's default delta-SPH strength
KERNELS = [
    # name, launch-count key, TPU kernel it replaces, the path that counts it
    ("density_pairs (self)", "density_self", "tpgsd/sph/pallas_ops.py:739",
     "summation"),
    ("density_pairs (cross)", "density_cross", "tpgsd/sph/pallas_ops.py:1360",
     "summation"),
    ("accel_pairs (self)", "accel_self", "tpgsd/sph/pallas_ops.py:833",
     "summation"),
    ("accel_pairs (cross)", "accel_cross", "tpgsd/sph/pallas_ops.py:1457",
     "summation"),
    ("accel_drho_pairs (self)", "accel_drho_self",
     "tpgsd/sph/pallas_ops.py:1012", "continuity"),
    ("accel_drho_pairs (cross)", "accel_drho_cross",
     "tpgsd/sph/pallas_ops.py:1190", "continuity"),
]
SOURCE = "tpgsd_torch/csrc/sph_pairs.cu"

# Roofline of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: float32 operations per pair within the support, counted from the
#: kernels' inner loops (an FMA is 2; sqrt, min/max and a divide 1 each):
#: differences and r^2 8, sqrt 1, the kernel weight 8 and its sum 2
#: (density); differences, r^2, sqrt and t^3 14, v_ij.x_ij 8, viscosity 6,
#: the scale 4 and three sums 6 (accel); the continuity bracket with
#: delta-SPH diffusion 7 and its sum 3 more (accel_drho).
FLOP_PER_PAIR = {"density": 19, "accel": 38, "accel_drho": 48}


def card_line():
    """``name, power limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events around the whole run, after ``warmup`` runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_scaled(name, got, want, live, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` on live slots, both scaled
    by max|want|; returns the raw max abs error."""
    got, want = got[live], want[live]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: non-finite kernel output" % name)
    scale = want.abs().max()
    err = (got - want).abs()
    ok = err / scale <= atol + rtol * want.abs() / scale
    if not bool(ok.all()):
        raise AssertionError(
            "%s: %d of %d live values outside rtol %g atol %g (max scaled "
            "error %.3e)" % (name, int((~ok).sum()), ok.numel(), rtol, atol,
                             float((err / scale).max()))
        )
    return float(err.max())


def spill_inputs(db, k, dev, seed=0):
    """Both tiers of the spill layout of the dam break at capacity ``k``,
    with a seeded jitter of 5% of the spacing and N(0, 1) velocities (so
    the viscosity and continuity terms are on), plus finished density and
    pressure."""
    rng = np.random.default_rng(seed)
    x0 = db.state.x.cpu().numpy()
    spacing = db.params.h / 1.3
    x = x0 + (0.05 * spacing) * rng.standard_normal(x0.shape).astype(np.float32)
    v = rng.standard_normal(x0.shape).astype(np.float32)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    v = torch.from_numpy(v).to(dev)
    grid = db.grid._replace(capacity=k)
    cells, sp = build_cells_spill(x, grid, k)
    xv = torch.cat([x, v], dim=-1)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    c = grid.n_cells
    ma, mb = cells.mask[:c].contiguous(), sp.mask[:c].contiguous()
    rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, db.params)

    def finish(r, m):
        r = torch.where(m, torch.clamp(r, min=0.1 * db.params.rho0), db.params.rho0)
        return r, torch.where(m, tait_pressure(r, db.params), 0.0)

    (ra, pa), (rb, pb) = finish(rho[0], ma), finish(rho[1], mb)
    return {
        "grid": grid,
        "a": (a[:3], a[3:], ra, pa, ma),
        "b": (b[:3], b[3:], rb, pb, mb),
    }


def check_drho_tiers(name, got, want, lives):
    """All four columns of both tiers of an ``accel_drho_spill`` result
    against the plain one (each column scaled by its max: rtol 1e-4, atol
    1e-5); returns the max abs errors ``(acc, drho)`` and max|drho|."""
    e_acc = e_drho = drho_max = 0.0
    for t, live in enumerate(lives):
        if not bool(live.any()):
            continue
        for col in range(4):
            if not bool(want[t][..., col].any()):
                if bool(got[t][..., col][live].any()):
                    raise AssertionError("%s: nonzero column %d" % (name, col))
                continue
            e = check_scaled("%s tier %d column %d" % (name, t, col),
                             got[t][..., col], want[t][..., col], live,
                             1e-4, 1e-5)
            if col < 3:
                e_acc = max(e_acc, e)
            else:
                e_drho = max(e_drho, e)
                drho_max = max(drho_max, float(want[t][..., 3][live].abs().max()))
    return e_acc, e_drho, drho_max


def phase_kernels_vs_plain(db, dev):
    """Phase 3: every kernel against its plain version on the 1M dam
    break at K = 24 (spill tier occupied) and K = 32 (the flagship);
    returns per-role errors and the inputs by K."""
    params = db.params
    # per role: the largest raw error of any output plane, the largest
    # error scaled by its plane's max, and the raw errors by plane group
    errs = {key: {"abs": 0.0, "scaled": 0.0, "planes": {}}
            for _, key, _, _ in KERNELS}
    inputs = {}
    for k in (24, 32):
        s = spill_inputs(db, k, dev)
        inputs[k] = s
        grid, a, b = s["grid"], s["a"], s["b"]
        n_spill = int(b[4].sum())
        print("phase 3: K=%d, %d particles in the spill tier" % (k, n_spill))
        if k == 24 and n_spill == 0:
            raise AssertionError("K=24 must occupy the spill tier")
        got = ops.density_spill(a[0], a[4], b[0], b[4], grid, params)
        want = ops.density_spill_plain(a[0], a[4], b[0], b[4], grid, params)
        for t, (live, name) in enumerate([(a[4], "rho_a"), (b[4], "rho_b")]):
            if bool(live.any()):
                e = check_scaled("density_spill K=%d %s" % (k, name),
                                 got[t], want[t], live, 1e-5, 1e-6)
                print("  density_spill %s max abs err %.6g" % (name, e))
        got = ops.accel_spill(*a, *b, grid, params)
        want = ops.accel_spill_plain(*a, *b, grid, params)
        for t, (live, name) in enumerate([(a[4], "acc_a"), (b[4], "acc_b")]):
            if bool(live.any()):
                e = check_scaled("accel_spill K=%d %s" % (k, name),
                                 got[t], want[t], live, 1e-4, 1e-5)
                print("  accel_spill %s max abs err %.6g" % (name, e))
        # the fused momentum + continuity pass: both smoothing kernels,
        # delta-SPH diffusion on and off
        for kern in (WendlandC2, CubicSpline):
            for delta in (DELTA_SPH, 0.0):
                kw = {"kernel": kern, "delta_sph": delta}
                got = ops.accel_drho_spill(*a, *b, grid, params, **kw)
                want = ops.accel_drho_spill_plain(*a, *b, grid, params, **kw)
                e_acc, e_drho, drho_max = check_drho_tiers(
                    "accel_drho_spill K=%d %s delta=%g" % (k, kern.__name__, delta),
                    got, want, (a[4], b[4]))
                print("  accel_drho_spill %s delta_sph=%g max abs err: acc "
                      "%.6g, drho %.6g (max|drho| %.6g)"
                      % (kern.__name__, delta, e_acc, e_drho, drho_max))
        # each role on its own: self (A <- A) and cross (A <- B, B <- A)
        roles = [
            ("density_self", lambda c, n, cross: ops.density_pairs(
                c[0], c[4], n[0], n[4], grid, params, cross=cross),
             lambda c, n: ops.density_pairs_plain(
                c[0], c[4], n[0], n[4], grid, params), 1e-5, 1e-6),
            ("accel_self", lambda c, n, cross: ops.accel_pairs(
                *c, *n, grid, params, cross=cross),
             lambda c, n: ops.accel_pairs_plain(*c, *n, grid, params),
             1e-4, 1e-5),
            ("accel_drho_self", lambda c, n, cross: ops.accel_drho_pairs(
                *c, *n, grid, params, delta_sph=DELTA_SPH, cross=cross),
             lambda c, n: ops.accel_drho_pairs_plain(
                *c, *n, grid, params, delta_sph=DELTA_SPH), 1e-4, 1e-5),
        ]
        for key, kern, plain, rtol, atol in roles:
            for cen, nbr, cross in ((a, a, False), (a, b, True), (b, a, True)):
                if not bool(cen[4].any()):
                    continue
                got, want = kern(cen, nbr, cross), plain(cen, nbr)
                if bool(got[..., ~cen[4]].any()):
                    raise AssertionError("%s K=%d: nonzero output on a dead "
                                         "centre slot" % (key, k))
                if not bool(want.any()):  # empty neighbour tier
                    if bool(got.any()):
                        raise AssertionError("%s K=%d: nonzero output from "
                                             "an empty tier" % (key, k))
                    continue
                role = key.replace("self", "cross") if cross else key
                # each output plane scaled by its own max
                planes = [(got, want)] if got.dim() == 2 else zip(got, want)
                rec = errs[role]
                for i, (g, w) in enumerate(planes):
                    e = check_scaled("%s K=%d" % (role, k), g, w, cen[4],
                                     rtol, atol)
                    group = "rho" if got.dim() == 2 else "drho" if i == 3 else "acc"
                    rec["abs"] = max(rec["abs"], e)
                    rec["scaled"] = max(
                        rec["scaled"], e / float(w[cen[4]].abs().max()))
                    rec["planes"][group] = max(rec["planes"].get(group, 0.0), e)
        if k == 24:
            # the cubic-spline branch of the density and acceleration
            # kernels (WendlandC2 is the flagship's kernel)
            for fn, plain, t, rtol, atol in (
                (ops.density_spill, ops.density_spill_plain, 0, 1e-5, 1e-6),
                (ops.accel_spill, ops.accel_spill_plain, 1, 1e-4, 1e-5),
            ):
                args = ((a[0], a[4], b[0], b[4]) if t == 0 else (*a, *b))
                got = fn(*args, grid, params, kernel=CubicSpline)
                want = plain(*args, grid, params, kernel=CubicSpline)
                e = check_scaled("CubicSpline %s K=24" % fn.__name__,
                                 got[0], want[0], a[4], rtol, atol)
                print("  CubicSpline %s max abs err %.6g" % (fn.__name__, e))
    for key, rec in errs.items():
        print("phase 3: %s max abs err %s, largest scaled by its plane's max "
              "%.3e" % (key, ", ".join("%s %.6g" % kv for kv in
                                       sorted(rec["planes"].items())),
                        rec["scaled"]))
    torch.cuda.synchronize()
    return errs, inputs


#: chunks of a frame and launches per step, by density mode; the
#: continuity path also launches the density kernel twice per role, once,
#: when ``entry`` seeds the carried density
PATHS = {
    "summation": {
        "chunks": ("position", "velocity", "density", "pressure", "slength"),
        "per_step": {"density_self": 2, "density_cross": 2,
                     "accel_self": 2, "accel_cross": 2},
        "seed": {},
    },
    "continuity": {
        "chunks": ("position", "velocity", "density"),
        "per_step": {"accel_drho_self": 2, "accel_drho_cross": 2},
        "seed": {"density_self": 2, "density_cross": 2},
    },
}


def phase_main_path(dev, card, params, density_mode):
    """Phase 4: the flagship step at 1M particles in ``density_mode``
    through the entry point, 20 steps, a frame every 5th step through the
    async dump into the port's writer; returns the launch counts of the
    whole path (seed included)."""
    path_of = PATHS[density_mode]
    tag = "phase 4 (%s)" % density_mode
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    step, (state,) = entry(n_side=N_1M, device=dev, density_mode=density_mode)
    want = {"use_kernels": True, "spill": True, "density_mode": density_mode}
    if step.resolved != want:
        raise AssertionError("flagship resolved to %r" % (step.resolved,))
    n = state.x.shape[0]
    if n != N_1M_PARTICLES:
        raise AssertionError("1M dam break has %d particles" % n)
    slength = torch.full((n,), params.h, device=dev)
    n_steps, every = 20, 5

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dam_break.gsd")
        writer = ShardedFrameWriter(
            path, application="tpgsd_torch.chip_smoke", comm=SingleComm(),
            static={"configuration/box": np.array(
                [2.0, 1.0, 1.0, 0.0, 0.0, 0.0], np.float32)},
        )
        print("%s: file handle %s" % (tag, type(writer.file._fh).__name__))
        overflow = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with AsyncDumpRunner(writer) as dump:
            for i in range(n_steps):
                state, (rho, p, ov) = step(state)
                overflow.append(ov)
                if i % every == every - 1:
                    frame = {"position": state.x, "velocity": state.v,
                             "density": rho, "pressure": p, "slength": slength}
                    dump.submit(
                        {"particles/" + c: frame[c] for c in path_of["chunks"]},
                        step=i,
                    )
            dump.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        stats = dump.stats
        print(
            "%s: %d steps at N=%d with %d frames of %d chunks in %.3f s (%.3f "
            "ms/step incl. dump), dump %.1f MB/s effective, %.1f MB/s while "
            "writing, overlap %.3f [%s]"
            % (tag, n_steps, n, stats.frames, len(path_of["chunks"]), wall,
               1e3 * wall / n_steps, stats.effective_mb_s, stats.write_mb_s,
               stats.overlap_efficiency, card)
        )
        total_overflow = int(torch.stack(overflow).sum())
        if total_overflow != 0:
            raise AssertionError("overflow %d in the main path" % total_overflow)
        for key, value in counts.items():
            expected = (path_of["per_step"].get(key, 0) * n_steps
                        + path_of["seed"].get(key, 0))
            if value != expected:
                raise AssertionError(
                    "%s launched %d times in %d steps (expected %d)"
                    % (key, value, n_steps, expected)
                )
        print("%s: launch counts %s" % (tag, json.dumps(counts)))

        with tpgsd_torch.hoomd.open(path, mode="r") as traj:
            if len(traj) != n_steps // every:
                raise AssertionError("%d frames written" % len(traj))
            for frame in traj:
                part = frame.particles
                if part.N != n:
                    raise AssertionError("frame N = %d" % part.N)
                for name in path_of["chunks"]:
                    arr = getattr(part, name)
                    if arr.shape[0] != n or not np.isfinite(arr).all():
                        raise AssertionError("frame %s malformed" % name)
            last = traj[-1]
            if int(last.configuration.step) != n_steps - 1:
                raise AssertionError("last frame step %r" % last.configuration.step)
            final_rho = state.rho if density_mode == "continuity" else rho
            for got, want_t in (
                (last.particles.position, state.x),
                (last.particles.velocity, state.v),
                (last.particles.density, final_rho),
            ):
                if not np.array_equal(got, want_t.cpu().numpy()):
                    raise AssertionError("last frame differs from the final state")
        print("%s: GSD file read back: %d frames, N=%d, finite, last "
              "frame == final state" % (tag, n_steps // every, n))
    return counts


#: slack of the carried-density comparison for the rounding of rho near
#: 1000 to float32: two units in the last place at rho >= 1024
RHO_ROUNDING = 2.5e-4


def phase_kernel_vs_plain_step(dev, density_mode):
    """Phase 5: one step of the kernel path against the plain path at
    100k particles, from a state 10 kernel steps into the run with seeded
    N(0, 0.1) velocities on top (so v_ij.x_ij, the viscosity and the
    continuity sum are far from zero).  In continuity mode the CHANGE of
    the carried density is compared too, scaled by its max (rtol 1e-4,
    atol 1e-5, plus the rounding of rho itself): a step whose drho/dt was
    zero, or lacked a term, would pass a tolerance relative to rho."""
    step_k, (state,) = entry(n_side=N_100K, device=dev,
                             density_mode=density_mode)
    db = dam_break(n_side=N_100K, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    step_p = make_step_fn(grid, db.params, use_kernels=False, spill=True,
                          density_mode=density_mode, device=dev)
    for _ in range(10):
        state, _aux = step_k(state)
    rng = np.random.default_rng(5)
    dv = 0.1 * rng.standard_normal(tuple(state.v.shape)).astype(np.float32)
    moving = state._replace(v=state.v + torch.from_numpy(dv).to(dev))
    sk, (rho_k, _pk, ov_k) = step_k(moving)
    sp, (rho_p, _pp, ov_p) = step_p(moving)
    if int(ov_k) or int(ov_p):
        raise AssertionError("overflow in the 100k comparison")
    torch.testing.assert_close(sk.x, sp.x, rtol=1e-5, atol=1e-6)
    if density_mode == "continuity":
        torch.testing.assert_close(sk.rho, sp.rho, rtol=1e-4, atol=1e-2)
        e = float((sk.rho - sp.rho).abs().max())
        d_k, d_p = sk.rho - moving.rho, sp.rho - moving.rho
        scale = float(d_p.abs().max())
        if scale < 100.0 * RHO_ROUNDING:
            raise AssertionError(
                "the carried density changed by at most %.3g in one step: "
                "too little to hold drho/dt" % scale)
        bad = (d_k - d_p).abs() > (1e-5 * scale + 1e-4 * d_p.abs()
                                   + RHO_ROUNDING)
        if bool(bad.any()):
            raise AssertionError(
                "the change of rho differs on %d particles (max %.3g on a "
                "change of %.3g)" % (int(bad.sum()),
                                     float((d_k - d_p).abs().max()), scale))
        rho_tol = ("rtol 1e-4 atol 1e-2, its change (max %.4g, median %.4g) "
                   "within rtol 1e-4 atol 1e-5 scaled + %.1e"
                   % (scale, float(d_p.abs().median()), RHO_ROUNDING))
    else:
        everything = torch.ones_like(rho_p, dtype=torch.bool)
        e = check_scaled("100k step rho", rho_k, rho_p, everything, 1e-5, 1e-6)
        rho_tol = "rtol 1e-5 atol 1e-6 scaled"
    print("phase 5 (%s): kernel path vs plain path at N=%d: positions within "
          "rtol 1e-5 atol 1e-6 (max abs %.3g), rho within %s (max abs err "
          "%.3g)" % (density_mode, state.x.shape[0],
                     float((sk.x - sp.x).abs().max()), rho_tol, e))
    return step_k, step_p, state


def count_pairs(cen, nbr_tier, grid, params, kernel):
    """Pairs (live centre, live neighbour slot of the 27 neighbour cells)
    within the kernel's support: the pairs whose terms are not zero, i.e.
    the work these inputs need."""
    (xc, mc), (xn, mn) = (cen[0], cen[4]), (nbr_tier[0], nbr_tier[4])
    c, k = mc.shape
    supp2 = (kernel.support_scale * params.h) ** 2
    nbr = neighbor_index(grid, xc.device)
    xn_s = _with_sentinel_cell(xn, 0.0)
    mn_s = _with_sentinel_cell(mn, False)
    total = 0
    for c0, c1 in _cell_blocks(c, k):
        nb = nbr[c0:c1]
        d = xc[:, c0:c1, :, None] - _gather_nbr(xn_s, nb)
        near = torch.sum(d * d, dim=0) < supp2
        total += int((near & _gather_nbr(mn_s, nb) & mc[c0:c1, :, None]).sum())
    return total


def needed_slots(cen_mask, nbr_mask, grid):
    """Slots whose fields one pair pass must read: live centre slots of
    cells with a live neighbour slot among their 27 cells, and live
    neighbour slots of cells next to a live centre.  A self pass reads
    each live slot once; a pass against an empty tier reads none."""
    nbr = neighbor_index(grid, cen_mask.device)  # [C, 27], sentinel C
    false = cen_mask.new_zeros((1,))

    def next_to(mask):  # [C]: a live slot of ``mask`` in the 27 cells
        return torch.cat([mask.any(dim=1), false])[nbr].any(dim=1)

    if nbr_mask is cen_mask:
        return int(cen_mask.sum())
    return int((cen_mask & next_to(nbr_mask)[:, None]).sum()) + int(
        (nbr_mask & next_to(cen_mask)[:, None]).sum())


def roofline(family, cen, nbr_tier, grid, params, kernel, n_out_planes):
    """``(bound_ms, bound_by, bytes, flop)`` of one pair pass on these
    inputs.  Bytes the function needs: the float32 input planes of the
    slots it must read (:func:`needed_slots`), each tier's mask in full
    (one byte a slot) and every output plane written once (zeros on dead
    slots included), over the HBM bandwidth; against the float32
    operations of the pairs within the support over the float32 peak."""
    c, k = cen[4].shape
    planes = 3 if family == "density" else 8  # f32 planes per tier
    tiers = 1 if nbr_tier is cen else 2  # a self pass reads its tier once
    n_bytes = (4 * planes * needed_slots(cen[4], nbr_tier[4], grid)
               + c * k * (tiers + 4 * n_out_planes))
    flop = FLOP_PER_PAIR[family] * count_pairs(cen, nbr_tier, grid, params, kernel)
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_flop else "operations"
    return 1e3 * max(t_bytes, t_flop), by, n_bytes, flop


def pair_passes(a, b, grid, params):
    """``family -> (output planes, kernel(cen, nbr, role), plain(cen,
    nbr))`` for tiers ``(x, v, rho, p, mask)``; the kernels are launched
    as the two-tier entry points launch them, on tiers whose pressure
    plane is folded beforehand."""
    folded = {id(t): t[:3] + (ops.pressure_plane(t[2], t[3], params),) + t[4:]
              for t in (a, b)}

    def accel(delta_sph):
        return lambda c, n, role: ops._launch_accel(
            *folded[id(c)], *folded[id(n)], grid, params, WendlandC2, role,
            delta_sph)

    return {
        "density": (
            1,
            lambda c, n, role: ops._launch_density(
                c[0], c[4], n[0], n[4], grid, params, WendlandC2, role),
            lambda c, n: ops.density_pairs_plain(
                c[0], c[4], n[0], n[4], grid, params)),
        "accel": (
            3, accel(None),
            lambda c, n: ops.accel_pairs_plain(*c, *n, grid, params)),
        "accel_drho": (
            4, accel(DELTA_SPH),
            lambda c, n: ops.accel_drho_pairs_plain(
                *c, *n, grid, params, delta_sph=DELTA_SPH)),
    }


def phase_times(dev, card, params, steps100, inputs24, inputs32):
    """Phase 6: step and kernel times on the card (CUDA events), and each
    kernel role's roofline bound on the same inputs (the flagship's K =
    32 and, with the spill tier occupied, K = 24)."""
    def step_ms(step, state, reps, warmup):
        box = [state]

        def run():
            box[0], _ = step(box[0])

        return cuda_ms(run, reps, warmup)

    for mode, (step_k100, step_p100, state100) in steps100.items():
        n100 = state100.x.shape[0]
        k100 = step_ms(step_k100, state100, 20, 3)
        p100 = step_ms(step_p100, state100, 3, 1)
        print("phase 6 (%s): N=%d kernel path %.4f ms/step (%.4g "
              "particle-steps/s), plain path %.4f ms/step (%.4g "
              "particle-steps/s) [%s]" % (mode, n100, k100, n100 / k100 * 1e3,
                                          p100, n100 / p100 * 1e3, card))

        step_k1m, (state1m,) = entry(n_side=N_1M, device=dev, density_mode=mode)
        n1m = state1m.x.shape[0]
        k1m = step_ms(step_k1m, state1m, 20, 3)
        msg = "phase 6 (%s): N=%d kernel path %.4f ms/step (%.4g " \
              "particle-steps/s)" % (mode, n1m, k1m, n1m / k1m * 1e3)
        est = p100 * n1m / n100 * 4 / 1e3  # seconds for warm-up + 3 steps
        if est < 60.0:
            step_p1m = make_step_fn(inputs32["grid"], params, use_kernels=False,
                                    spill=True, density_mode=mode, device=dev)
            p1m = step_ms(step_p1m, state1m, 3, 1)
            msg += ", plain path %.4f ms/step (%.4g particle-steps/s)" % (
                p1m, n1m / p1m * 1e3)
        else:
            msg += ", plain path not measured (estimated %.0f s > 60 s)" % est
        print(msg + " [%s]" % card)
        del step_k1m, state1m

    # each kernel role at the main paths' shapes (K = 32, centres in the
    # main tier; the spill tier is empty there): these are the rows of the
    # ``kernels`` line
    grid, a, b = inputs32["grid"], inputs32["a"], inputs32["b"]
    times = {}
    for family, (n_out, kern, plain) in pair_passes(a, b, grid, params).items():
        for role, nbr_tier in (("self", a), ("cross", b)):
            kms = cuda_ms(lambda: kern(a, nbr_tier, role), 20, 3)
            pms = cuda_ms(lambda: plain(a, nbr_tier), 3, 1)
            bound_ms, by, n_bytes, flop = roofline(
                family, a, nbr_tier, grid, params, WendlandC2, n_out)
            key = "%s_%s" % (family, role)
            times[key] = {"ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                          "bound_by": by}
            print("phase 6: %s at N=%d, K=%d (centres A): kernel %.4f ms, "
                  "plain %.4f ms, bound %.4f ms by %s (%.4g bytes, %.4g flop; "
                  "kernel at %.1f%% of the bound's rate) [%s]"
                  % (key, N_1M_PARTICLES, grid.capacity, kms, pms, bound_ms,
                     by, n_bytes, flop, 100.0 * bound_ms / kms, card))

    # the same kernels at K = 24, where the spill tier is occupied: every
    # pass of the two-tier sums (centres <- neighbours)
    grid, a, b = inputs24["grid"], inputs24["a"], inputs24["b"]
    names = {id(a): "A", id(b): "B"}
    for family, (n_out, kern, _plain) in pair_passes(a, b, grid, params).items():
        for cen, nbr_tier in ((a, a), (a, b), (b, a), (b, b)):
            role = "self" if nbr_tier is cen else "cross"
            kms = cuda_ms(lambda: kern(cen, nbr_tier, role), 20, 3)
            bound_ms, by, n_bytes, flop = roofline(
                family, cen, nbr_tier, grid, params, WendlandC2, n_out)
            print("phase 6: %s_%s at N=%d, K=%d, %s <- %s (%d live centres, "
                  "%d live neighbours): kernel %.4f ms, bound %.4f ms by %s "
                  "(%.4g bytes, %.4g flop; kernel at %.1f%% of the bound's "
                  "rate) [%s]"
                  % (family, role, N_1M_PARTICLES, grid.capacity,
                     names[id(cen)], names[id(nbr_tier)], int(cen[4].sum()),
                     int(nbr_tier[4].sum()), kms, bound_ms, by, n_bytes, flop,
                     100.0 * bound_ms / kms, card))
    return times


#: layer groups of the profile, by a fragment of the device kernel's name
#: (first match wins; the rest is elementwise: EOS, integrate, masks)
PROFILE_GROUPS = [
    ("pair kernels", ("_pairs_kernel",)),
    ("cummax scan (cell build)", ("scan_innermost_dim_with_indices",)),
    ("radix sort (cell build)", ("RadixSort",)),
    ("cat copies", ("CatArray",)),
    ("index gathers", ("index_elementwise",)),
    ("memcpy/memset", ("Memcpy", "Memset")),
]


def _union_us(spans):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def phase_profile(dev, card, n_side, density_mode, steps=10, warmup=5):
    """Phase 7: one torch.profiler trace of ``steps`` flagship steps.
    The device busy time (union of the device activity) and the wall
    time both come from that trace: wall is the span of a host region
    that ends with a device sync.  The profiler slows the host side, so
    the idle share is that of the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step, (state,) = entry(n_side=n_side, device=dev, density_mode=density_mode)
    n = state.x.shape[0]
    for _ in range(warmup):
        state, _aux = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("tpgsd_torch.profiled_steps"):
            for _ in range(steps):
                state, _aux = step(state)
            torch.cuda.synchronize()
    events = prof.events()
    # the host region (the trace also mirrors it on the device timeline)
    region = [e for e in events if e.name == "tpgsd_torch.profiled_steps"
              and e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "tpgsd_torch.profiled_steps"]
    if len(region) != 1 or not device:
        raise AssertionError(
            "profile: %d host regions and %d device events (the trace "
            "needs both)" % (len(region), len(device))
        )
    t0, t1 = region[0].time_range.start, region[0].time_range.end
    inside = [(max(e.time_range.start, t0), min(e.time_range.end, t1))
              for e in device]
    busy = _union_us([(s, e) for s, e in inside if e > s])
    wall = t1 - t0
    outside = sum(1 for s, e in inside if e <= s)
    print("phase 7 (%s): N=%d profiled %d steps: wall %.4f ms/step, device "
          "busy %.4f ms/step, idle share %.4f (%d device events outside the "
          "region) [%s]" % (density_mode, n, steps, wall / steps / 1e3,
                            busy / steps / 1e3, 1.0 - busy / wall, outside,
                            card))
    groups = {}
    for e in device:
        g = next((name for name, keys in PROFILE_GROUPS
                  if any(k in e.name for k in keys)), "elementwise/other")
        us, count = groups.get(g, (0.0, 0))
        groups[g] = (us + e.time_range.elapsed_us(), count + 1)
    total = sum(us for us, _ in groups.values())
    for g, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print("  %-26s %.4f ms/step (%.1f%% of device time), %.1f "
              "launches/step" % (g, us / steps / 1e3, 100.0 * us / total,
                                 count / steps))


def check_no_reference_modules():
    """The run must not have loaded JAX or the JAX package."""
    loaded = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpgsd")
    )
    if loaded:
        raise AssertionError("reference modules were imported: %s" % loaded[:8])


def main():
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
            "is false"
        )
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("card: %s" % card)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))

    t0 = time.perf_counter()
    _build.load()
    print("phase 2: kernels built and loaded in %.2f s: %s" % (
        time.perf_counter() - t0, _build.library_path().name))
    log = _build.library_path().with_suffix(".so.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas: " + line.strip())

    db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    print("1M dam break: N=%d, grid %s, K=%d" % (
        db.n, "x".join(map(str, db.grid.dims)), db.grid.capacity))
    params = db.params
    errs, inputs = phase_kernels_vs_plain(db, dev)
    del db
    counts = {mode: phase_main_path(dev, card, params, mode) for mode in PATHS}
    steps100 = {mode: phase_kernel_vs_plain_step(dev, mode) for mode in PATHS}
    times = phase_times(dev, card, params, steps100, inputs[24], inputs[32])
    del steps100, inputs
    for mode in PATHS:
        for n_side in (N_100K, N_1M):
            phase_profile(dev, card, n_side, mode)
    check_no_reference_modules()
    print("no jax, jaxlib or tpgsd module was imported")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": counts[path][key],
            "max_abs_err": errs[key]["abs"],
            "max_scaled_err": errs[key]["scaled"],
            "ms": times[key]["ms"],
            "plain_ms": times[key]["plain_ms"],
            "bound_ms": times[key]["bound_ms"],
            "bound_by": times[key]["bound_by"],
            # no single PyTorch call computes these pair sums
            "library_ms": None,
        }
        for name, key, replaces, path in KERNELS
    ]
    print("card: %s" % card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
