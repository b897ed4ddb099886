"""Smoke run of the tpgsd_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA pair kernels from ``tpgsd_torch/csrc`` (nvcc, first use),
holds each against its plain PyTorch version on the 1M-particle dam break,
drives the port's main path (the flagship spill step with its async GSD
dump) for 20 steps, checks the written file and the kernel launch counts,
compares one step of the kernel path with the plain path, times both, and
profiles the flagship step at 100k and 1M particles (torch.profiler: the
device time per layer and the device's idle share, from one trace each).
Every phase raises on failure; the script exits non-zero and prints no
result line.  It needs a CUDA device and never runs on the CPU.

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

import tpgsd.hoomd
from tpgsd.parallel import ShardedFrameWriter
from tpgsd.parallel.comm import SingleComm
from tpgsd_torch import _build
from tpgsd_torch.entry import entry
from tpgsd_torch.io_runtime import AsyncDumpRunner
from tpgsd_torch.sph import CubicSpline, dam_break, make_step_fn, ops
from tpgsd_torch.sph.cells import build_cells_spill, scatter_to_cells_soa
from tpgsd_torch.sph.step import tait_pressure

N_1M = 86  # n_side of the 1,003,104-particle dam break
N_1M_PARTICLES = 1003104
N_100K = 40  # n_side of the 100,000-particle dam break
KERNELS = [
    # name, launch-count key, TPU kernel it replaces
    ("density_pairs (self)", "density_self", "tpgsd/sph/pallas_ops.py:739"),
    ("density_pairs (cross)", "density_cross", "tpgsd/sph/pallas_ops.py:1360"),
    ("accel_pairs (self)", "accel_self", "tpgsd/sph/pallas_ops.py:833"),
    ("accel_pairs (cross)", "accel_cross", "tpgsd/sph/pallas_ops.py:1457"),
]
SOURCE = "tpgsd_torch/csrc/sph_pairs.cu"


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
    the viscosity term is on), plus finished density and pressure."""
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


def phase_kernels_vs_plain(db, dev):
    """Phase 3: every kernel against its plain version on the 1M dam
    break at K = 24 (spill tier occupied) and K = 32 (the flagship);
    returns per-role max abs errors and the K = 32 inputs."""
    params = db.params
    errs = {key: 0.0 for _, key, _ in KERNELS}
    inputs32 = None
    for k in (24, 32):
        s = spill_inputs(db, k, dev)
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
        ]
        for key, kern, plain, rtol, atol in roles:
            for cen, nbr, cross in ((a, a, False), (a, b, True), (b, a, True)):
                if not bool(cen[4].any()):
                    continue
                got, want = kern(cen, nbr, cross), plain(cen, nbr)
                if not bool(want.any()):  # empty neighbour tier
                    if bool(got.any()):
                        raise AssertionError("%s K=%d: nonzero output from "
                                             "an empty tier" % (key, k))
                    continue
                live = cen[4] if got.dim() == 2 else cen[4].expand(3, -1, -1)
                role = key.replace("self", "cross") if cross else key
                e = check_scaled("%s K=%d" % (role, k), got, want, live, rtol, atol)
                errs[role] = max(errs[role], e)
        if k == 24:
            # the cubic-spline branch of both kernels (WendlandC2 is the
            # flagship's kernel)
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
        if k == 32:
            inputs32 = s
    torch.cuda.synchronize()
    return errs, inputs32


def phase_main_path(dev, card, params):
    """Phase 4: the flagship step at 1M particles, 20 steps, a frame
    every 5th step through the async dump; returns the launch counts."""
    step, (state,) = entry(n_side=N_1M, device=dev)
    want = {"use_kernels": True, "spill": True, "density_mode": "summation"}
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
        overflow = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with AsyncDumpRunner(writer) as dump:
            for i in range(n_steps):
                state, (rho, p, ov) = step(state)
                overflow.append(ov)
                if i % every == every - 1:
                    dump.submit(
                        {
                            "particles/position": state.x,
                            "particles/velocity": state.v,
                            "particles/density": rho,
                            "particles/pressure": p,
                            "particles/slength": slength,
                        },
                        step=i,
                    )
            dump.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        stats = dump.stats
        print(
            "phase 4: %d steps at N=%d with %d frames in %.3f s (%.3f "
            "ms/step incl. dump), dump %.1f MB/s effective, overlap %.3f "
            "[%s]" % (n_steps, n, stats.frames, wall, 1e3 * wall / n_steps,
                      stats.effective_mb_s, stats.overlap_efficiency, card)
        )
        total_overflow = int(torch.stack(overflow).sum())
        if total_overflow != 0:
            raise AssertionError("overflow %d in the main path" % total_overflow)
        for key, value in counts.items():
            if value != 2 * n_steps:
                raise AssertionError(
                    "%s launched %d times in %d steps (expected %d)"
                    % (key, value, n_steps, 2 * n_steps)
                )
        print("phase 4: launch counts %s" % json.dumps(counts))

        with tpgsd.hoomd.open(path, mode="r") as traj:
            if len(traj) != n_steps // every:
                raise AssertionError("%d frames written" % len(traj))
            for frame in traj:
                part = frame.particles
                if part.N != n:
                    raise AssertionError("frame N = %d" % part.N)
                for name in ("position", "velocity", "density", "pressure",
                             "slength"):
                    arr = getattr(part, name)
                    if arr.shape[0] != n or not np.isfinite(arr).all():
                        raise AssertionError("frame %s malformed" % name)
            last = traj[-1]
            if int(last.configuration.step) != n_steps - 1:
                raise AssertionError("last frame step %r" % last.configuration.step)
            for got, want_t in (
                (last.particles.position, state.x),
                (last.particles.velocity, state.v),
                (last.particles.density, rho),
            ):
                if not np.array_equal(got, want_t.cpu().numpy()):
                    raise AssertionError("last frame differs from the final state")
        print("phase 4: GSD file read back: %d frames, N=%d, finite, last "
              "frame == final state" % (n_steps // every, n))
    return counts


def phase_kernel_vs_plain_step(dev):
    """Phase 5: one step of the kernel path against the plain path at
    100k particles, from a state 10 kernel steps into the run."""
    step_k, (state,) = entry(n_side=N_100K, device=dev)
    db = dam_break(n_side=N_100K, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    grid = db.grid._replace(capacity=min(max(db.grid.capacity, 24), 64))
    step_p = make_step_fn(grid, db.params, use_kernels=False, spill=True,
                          device=dev)
    for _ in range(10):
        state, _aux = step_k(state)
    sk, (rho_k, _pk, ov_k) = step_k(state)
    sp, (rho_p, _pp, ov_p) = step_p(state)
    if int(ov_k) or int(ov_p):
        raise AssertionError("overflow in the 100k comparison")
    everything = torch.ones_like(rho_p, dtype=torch.bool)
    torch.testing.assert_close(sk.x, sp.x, rtol=1e-5, atol=1e-6)
    e = check_scaled("100k step rho", rho_k, rho_p, everything, 1e-5, 1e-6)
    print("phase 5: kernel path vs plain path at N=%d: positions within "
          "rtol 1e-5 atol 1e-6 (max abs %.3g), rho max abs err %.3g"
          % (state.x.shape[0], float((sk.x - sp.x).abs().max()), e))
    return step_k, step_p, state


def phase_times(dev, card, params, step_k100, step_p100, state100,
                inputs32):
    """Phase 6: step and kernel times on the card (CUDA events)."""
    def step_ms(step, state, reps, warmup):
        box = [state]

        def run():
            box[0], _ = step(box[0])

        return cuda_ms(run, reps, warmup)

    n100 = state100.x.shape[0]
    k100 = step_ms(step_k100, state100, 20, 3)
    p100 = step_ms(step_p100, state100, 3, 1)
    print("phase 6: N=%d kernel path %.4f ms/step (%.4g particle-steps/s), "
          "plain path %.4f ms/step (%.4g particle-steps/s) [%s]"
          % (n100, k100, n100 / k100 * 1e3, p100, n100 / p100 * 1e3, card))

    step_k1m, (state1m,) = entry(n_side=N_1M, device=dev)
    n1m = state1m.x.shape[0]
    k1m = step_ms(step_k1m, state1m, 20, 3)
    msg = "phase 6: N=%d kernel path %.4f ms/step (%.4g particle-steps/s)" % (
        n1m, k1m, n1m / k1m * 1e3)
    est = p100 * n1m / n100 * 4 / 1e3  # seconds for warm-up + 3 steps
    if est < 60.0:
        g = inputs32["grid"]
        step_p1m = make_step_fn(g, params, use_kernels=False, spill=True,
                                device=dev)
        p1m = step_ms(step_p1m, state1m, 3, 1)
        msg += ", plain path %.4f ms/step (%.4g particle-steps/s)" % (
            p1m, n1m / p1m * 1e3)
    else:
        msg += ", plain path not measured (estimated %.0f s > 60 s)" % est
    print(msg + " [%s]" % card)

    grid, a, b = inputs32["grid"], inputs32["a"], inputs32["b"]
    pta = ops.pressure_plane(a[2], a[3], params)
    ptb = ops.pressure_plane(b[2], b[3], params)
    a_pt = a[:3] + (pta,) + a[4:]
    b_pt = b[:3] + (ptb,) + b[4:]
    runs = {
        "density_self": (
            lambda: ops._launch_density(a[0], a[4], a[0], a[4], grid, params,
                                        ops.WendlandC2, "self"),
            lambda: ops.density_pairs_plain(a[0], a[4], a[0], a[4], grid, params),
        ),
        "density_cross": (
            lambda: ops._launch_density(a[0], a[4], b[0], b[4], grid, params,
                                        ops.WendlandC2, "cross"),
            lambda: ops.density_pairs_plain(a[0], a[4], b[0], b[4], grid, params),
        ),
        "accel_self": (
            lambda: ops._launch_accel(*a_pt, *a_pt, grid, params,
                                      ops.WendlandC2, "self"),
            lambda: ops.accel_pairs_plain(*a, *a, grid, params),
        ),
        "accel_cross": (
            lambda: ops._launch_accel(*a_pt, *b_pt, grid, params,
                                      ops.WendlandC2, "cross"),
            lambda: ops.accel_pairs_plain(*a, *b, grid, params),
        ),
    }
    times = {}
    for key, (kern, plain) in runs.items():
        kms = cuda_ms(kern, 20, 3)
        pms = cuda_ms(plain, 3, 1)
        times[key] = (kms, pms)
        print("phase 6: %s at N=%d, K=%d (centres A): kernel %.4f ms, plain "
              "%.4f ms [%s]" % (key, n1m, grid.capacity, kms, pms, card))
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


def phase_profile(dev, card, n_side, steps=10, warmup=5):
    """Phase 7: one torch.profiler trace of ``steps`` flagship steps.
    The device busy time (union of the device activity) and the wall
    time both come from that trace: wall is the span of a host region
    that ends with a device sync.  The profiler slows the host side, so
    the idle share is that of the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step, (state,) = entry(n_side=n_side, device=dev)
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
    print("phase 7: N=%d profiled %d steps: wall %.4f ms/step, device busy "
          "%.4f ms/step, idle share %.4f (%d device events outside the "
          "region) [%s]" % (n, steps, wall / steps / 1e3, busy / steps / 1e3,
                            1.0 - busy / wall, outside, card))
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
    errs, inputs32 = phase_kernels_vs_plain(db, dev)
    del db
    counts = phase_main_path(dev, card, params)
    step_k, step_p, state100 = phase_kernel_vs_plain_step(dev)
    times = phase_times(dev, card, params, step_k, step_p, state100,
                        inputs32)
    del step_k, step_p, state100, inputs32
    for n_side in (N_100K, N_1M):
        phase_profile(dev, card, n_side)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": counts[key],
            "max_abs_err": errs[key],
            "ms": times[key][0],
            "plain_ms": times[key][1],
        }
        for name, key, replaces in KERNELS
    ]
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
