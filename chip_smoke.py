"""Smoke run of the tpgsd_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA pair kernels from ``tpgsd_torch/csrc`` (nvcc, first use;
the registers of every instance from ``ptxas -v``, those of the nine
kernels' instances held to what they were before the option passes came),
holds each of the nine kernel roles against its plain PyTorch version on
the 1M-particle dam break (the two-tier roles at K = 24 and 32, the wide
single-tier roles at K = 128, and at 100k particles K = 96, 256 and an
arbitrary mask) and on the ghost tiers of the 1M periodic still box (the
two-tier roles at its own K, the wide roles at K = 128) and the 2-D
Taylor-Green vortex, drives the port's main paths for 20 steps each with the
async GSD dump through the port's own writer (the flagship spill step and
the single-tier K = 128 step, in summation and in continuity density
mode), checks the written files and the kernel launch counts, runs the
periodic workloads (a 1M still box on both layouts, a 2-D Taylor-Green
vortex), compares one step of each kernel path with its plain path, times
steps and kernels beside each kernel's roofline bound (the tile kernels
with their tile size T and shared memory; the tile kernels at K = 128
against K = 32 on the same particles), and profiles the 1M steps
(torch.profiler: the device time per layer and the device's idle share,
from one trace each).
The step's options run on the card too, through the pair passes that the
reference runs in jnp (XSPH, riding the momentum kernel; the Akinci
surface normals and force; the energy rate): each of their roles is held
against its plain version (on the 1M dam break at K = 24 and 32, at 100k
on the single tier at K = 128, on the periodic still box's ghost grid),
the 1M dam break steps with ``xsph=0.5, surface_tension=0.05`` on both
layouts in both modes with the dump, ``energy_rate`` runs at 1M, their
kernel steps are held against the plain steps at 100k, and their roles
and steps are timed.
Phase 4b holds the row kernel (``slot_rows_kernel``, every step's finish:
the per-slot results to particle rows) bit for bit against its twin of
torch operations (``ops.slot_rows_plain``, which the steps built with
``use_kernels=False`` run, so every kernel-against-plain comparison here
holds the row kernel too) on the 1M step's own tiers (spill summation,
5 columns, and continuity with the options, 7), and phase 9 on one
slab window of the 1e8 step; both are timed beside the kernel's byte
bound, and the main paths count its launches (one a step, and one the
continuity seed).
Phase 8 drives the long-run time loop at 1M: the adaptive step
(``make_adaptive_step_fn``) at ``dt == params.dt`` bit-identical to the
fixed step with the same launches on both layouts in both modes (then
both timed and the adaptive one profiled); a 200-step ``run_adaptive``
rollout of the spill step under ``torch.cuda.set_sync_debug_mode("error")``
(no host sync), its dts and ``t`` checked; the same rollout with in-loop
dumps (``scan_simulate_adaptive``, a frame every 10th step) read back
against the rollout without a dump; ``resume`` from that file with 10
more steps appended; and ``dam_break(on_device=True)`` against the host
lattice.
Phase 9 drives the slab-sequential step (``make_slab_step_fn``): one
slab kernel step against one slab plain step at 113,568 particles on 4
slabs (spill K = 32 and 24, single tier K = 128, both modes: all nine
kernel roles on a slab's extended grid; positions, velocities and
density compared); the slab step against the
global step at 1,064,800 particles on 12 slabs, 3 steps, both layouts
and modes (bit-identity reported); 20 silent slab steps under
``torch.cuda.set_sync_debug_mode("error")`` and a profile; the global
step's peak bytes a particle at 1M and the N at which it would fill the
card; and the reference's 1e8-particle cycle
(``benchmarks/benchmark_bigcycle.py --n-side 400 --slabs 32 --spill``):
100,000,000 particles on 32 slabs, timed silent steps in both modes
with their peak memory and a profile, the three two-tier pair passes
against their plain versions on the extended grids of three slabs of
the stepped 1e8 state (the first, the water column's front, and one
midway), a 3-step cycle streaming one
position + velocity frame through ``SlabDumpChannel``, resumed, stepped
once more and checked by ``tpgsd_torch.pypgsd.verify(deep=True)``.
Phase 10 drives the slab domain decomposition
(``make_distributed_step_fn``) with its shards on the card: the 1M dam
break on 2 shards (the reference benchmark's slabs of 41 planes), spill
K = 32 and single tier K = 128, both modes, 3 steps against the global
kernel step at the reference's decomposition tolerances, the first
against the plain decomposed step, every particle once, overflow 0, the
launches of a step (shards x the global step's), both steps timed; a
4-shard dam break (108,000 particles) with XSPH, surface tension and the
energy rate, particles crossing every face, each of 5 steps against the
plain decomposed step; the periodic 1M still box on a ring of 2 shards,
20 steps in both modes; the adaptive decomposed step bit-identical to
the fixed one at ``dt == params.dt`` and a 200-step rollout with no host
sync; ``resume_distributed`` of a 2-frame file onto 1 and 2 shards; with
one visible GPU the shards share ``cuda:0`` and the script says that
cross-device copies were not exercised.
Phase 11 drives the 2-D and 3-D block decompositions
(``make_distributed2d_step_fn`` on a (2, 2) mesh,
``make_distributed3d_step_fn`` on (2, 2, 2), every shard on ``cuda:0``):
the 1M dam break at ``n_side=88`` (84 x 42 x 42 cells), spill K = 32 and
single tier K = 128, both modes, 3 steps against the global kernel step
and the first against the plain block step, the launches of a step and
of a step with the options; the degenerate (2, 1) mesh against the slab
step and (2, 2, 1) against (2, 2); the 110,592-particle cube with the
options, N(0, 10^2) velocities and a particle moved across the blocks'
corner, 5 steps each against the plain block step, every face crossed;
the periodic 1M still box through the rings; the adaptive forms
bit-identical to the fixed ones and a 200-step rollout with no host
sync; a 2-frame file resumed onto (2, 2), (1, 1) and (2, 2, 2); and the
ms/step of both forms beside the global and the 2-shard slab step, with
a profile of the 3-D step.
Phase 12 runs the decompositions with one OS process per rank
(``tpgsd_torch.parallel.worker`` processes over ``TorchProcessComm`` and
Gloo, every process on ``cuda:0``, the kernels built by this process
first): the slab form on 2 processes (the phase-10 dam break, spill K =
32 and single tier K = 128), (2, 2) on 4 and (2, 2, 2) on 8 (the
phase-11 dam break, spill K = 32), both modes, 3 steps each; every
process's shards held bit for bit to the single-controller step run
here, overflow 0, every particle once, each role's launches a step
summed over the processes equal to the single controller's, and both
timed (host clock, with the host syncs, bytes and exchange time of the
Gloo staging); the (2, 2) dump cycle through ``ShardedFrameWriter`` and
``ComposedFrameWriter`` over the processes, each file byte-equal to one
process's and ``verify(deep=True)``; the controller killed mid-frame
(the file reopens at 3 frames); and a one-process NCCL group (the
wiring only: one GPU allows no NCCL point-to-point).
Phase 13 terminates the main path and reads what it left: a child
process (``chip_smoke.py --sigterm-child PATH H``, a mode only this
script uses) runs the flagship 1M spill summation step through
``configuration`` and submits a frame every step (position, velocity,
density, pressure, slength; about 36 MB) through ``AsyncDumpRunner``
(depth 4) into ``ShardedFrameWriter``; once it has printed ``submitted
8`` the parent sends SIGTERM.  The package's handler turns the signal
into ``SystemExit(1)``, so the child must exit with 1 and its runner
drain: the file passes ``pypgsd.verify(deep=True)``, holds at least 8
frames and every frame the child submitted, each bit-equal to the same
step run here, with the kernel launches of that many steps; the drain
time and the frames written after the signal are printed.  Then the
port's command line runs on that file as ``python -m tpgsd_torch`` with
``torch``, ``jax`` and ``tpgsd`` blocked in ``sys.modules``: ``info``
(the frame count, ``[1003104 x 3] float32``), ``dump``, ``verify`` (OK,
and CORRUPT on a copy cut inside the last frame's positions) and
``convert --frames 0:1`` (one ``.vtu`` of 1,003,104 points), each with
its wall time.
Every phase raises on failure; the script exits non-zero and prints no
result line.  It needs a CUDA device and never runs on the CPU, and it
imports nothing of JAX or of the JAX package ``tpgsd``.

The second-to-last line of standard output is a JSON object with one
entry per kernel role (``slab_launches``: its launches in the 4 silent
steps a mode of the 1e8 cycle; ``decomp_launches``: in one decomposed
1M step on 2 shards; ``decomp2d_launches`` / ``decomp3d_launches``: in
one 1M step of the (2, 2) / (2, 2, 2) block form; ``mp_launches``: in one
1M step of each form over processes, summed over them;
``sigterm_launches``: in phase 13's terminated run); the last line
is the run's result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import tpgsd_torch.fl
import tpgsd_torch.hoomd
import tpgsd_torch.pypgsd
from tpgsd_torch import _build
from tpgsd_torch.entry import entry
from tpgsd_torch.io_runtime import (
    AsyncDumpRunner,
    JitDumpChannel,
    SlabDumpChannel,
    scan_simulate_adaptive,
)
from tpgsd_torch.parallel import (
    ShardedFrameWriter,
    SingleComm,
    launch,
    make_mesh,
    make_mesh2d,
    make_mesh3d,
    worker,
)
from tpgsd_torch.sph import (
    CubicSpline,
    WendlandC2,
    collect_aux,
    collect_state,
    dam_break,
    distribute_state,
    distribute_state_2d,
    distribute_state_3d,
    energy_rate,
    init_density,
    make_adaptive_distributed2d_step_fn,
    make_adaptive_distributed3d_step_fn,
    make_adaptive_distributed_step_fn,
    make_adaptive_step_fn,
    make_distributed2d_step_fn,
    make_distributed3d_step_fn,
    make_distributed_step_fn,
    make_slab_step_fn,
    make_step_fn,
    ops,
    resume,
    resume_distributed,
    resume_distributed2d,
    resume_distributed3d,
    run_adaptive,
    slab_init_density,
    still_box,
    taylor_green,
)
from tpgsd_torch.sph.bigstep import _PAD, slab_tiers
from tpgsd_torch.sph.cells import (
    build_cells,
    build_cells_spill,
    cell_id,
    gather_from_cells,
    scatter_to_cells_soa,
    wrap_axes,
)
from tpgsd_torch.sph.step import (
    _cell_blocks,
    _gather_nbr,
    _with_sentinel_cell,
    initial_dt,
    neighbor_index,
    tait_pressure,
)

N_1M = 86  # n_side of the 1,003,104-particle dam break
N_1M_PARTICLES = 1003104
BOX = np.array([2.0, 1.0, 1.0, 0.0, 0.0, 0.0], np.float32)  # its box
DIMS_1M, K_1M = (82, 41, 41), 32  # its grid and "auto" capacity
N_100K = 40  # n_side of the 100,000-particle dam break
K_WIDE = 128  # the single-tier capacity past the two-tier kernels' 64
N_BOX_1M = 100  # n_side of the 1,000,000-particle periodic still box
N_BOX_64K = 40  # n_side of the 64,000-particle periodic still box
N_VORTEX = 512  # n_side of the 262,144-particle 2-D Taylor-Green vortex
DELTA_SPH = 0.1  # make_step_fn's default delta-SPH strength
N_ROLLOUT = 200  # steps of phase 8's adaptive rollouts
DUMP_EVERY = 10  # their dump cadence
N_RESUMED = 10  # steps after the resume
#: phase 9's slab configurations: (n_side, particles, grid, slabs)
SLAB_100K = (42, 113568, (40, 20, 20), 4)
SLAB_1M = (88, 1064800, (84, 42, 42), 12)
#: the reference's 1e8-particle cycle (benchmarks/benchmark_bigcycle.py
#: --n-side 400 --slabs 32 --spill)
SLAB_1E8 = (400, 100000000, (384, 192, 192), 32)
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
    ("density (wide)", "density_wide", "tpgsd/sph/pallas_ops.py:190",
     "wide summation"),
    ("accel (wide)", "accel_wide", "tpgsd/sph/pallas_ops.py:259",
     "wide summation"),
    ("accel_drho (wide)", "accel_drho_wide", "tpgsd/sph/pallas_ops.py:391",
     "wide continuity"),
    # the pair passes the reference runs in jnp, not in Pallas: "replaces"
    # names the jnp pass (the energy pass's cross role runs on the
    # decomposed step's two tiers with compute_energy)
    ("accel_pairs<xsph> (self)", "accel_xsph_self",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "options summation"),
    ("accel_pairs<xsph> (cross)", "accel_xsph_cross",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "options summation"),
    ("accel_drho_pairs<xsph> (self)", "accel_drho_xsph_self",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "options continuity"),
    ("accel_drho_pairs<xsph> (cross)", "accel_drho_xsph_cross",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "options continuity"),
    ("accel<xsph> (wide)", "accel_xsph_wide",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "wide options summation"),
    ("accel_drho<xsph> (wide)", "accel_drho_xsph_wide",
     "jnp: tpgsd/sph/step.py:166 _xsph_blocks", "wide options continuity"),
    ("st_normals (self)", "st_normals_self",
     "jnp: tpgsd/sph/step.py:260 _st_normals_blocks", "options summation"),
    ("st_normals (cross)", "st_normals_cross",
     "jnp: tpgsd/sph/step.py:260 _st_normals_blocks", "options summation"),
    ("st_normals (wide)", "st_normals_wide",
     "jnp: tpgsd/sph/step.py:260 _st_normals_blocks",
     "wide options summation"),
    ("st_force (self)", "st_force_self",
     "jnp: tpgsd/sph/step.py:289 _st_force_blocks", "options summation"),
    ("st_force (cross)", "st_force_cross",
     "jnp: tpgsd/sph/step.py:289 _st_force_blocks", "options summation"),
    ("st_force (wide)", "st_force_wide",
     "jnp: tpgsd/sph/step.py:289 _st_force_blocks", "wide options summation"),
    ("energy (self)", "energy_self",
     "jnp: tpgsd/sph/step.py:482 _energy_blocks", "energy_rate"),
    ("energy (cross)", "energy_cross",
     "jnp: tpgsd/sph/step.py:482 _energy_blocks",
     "decomposed options summation"),
    ("energy (wide)", "energy_wide",
     "jnp: tpgsd/sph/step.py:482 _energy_blocks", "wide energy_rate"),
]
SOURCE = "tpgsd_torch/csrc/sph_pairs.cu"
#: the row kernel's times, filled by phases 4b and 9 for the ``kernels``
#: line: ``{"1M": {...}, "1e8 window": {...}}``
ROW_TIMES = {}
#: the reference's own option settings (tests/test_spill.py)
OPTIONS = {"xsph": 0.5, "surface_tension": 0.05}
#: the pair passes the reference runs in jnp, by launch-count family
OPTION_FAMILIES = ("accel_xsph", "accel_drho_xsph", "st_normals", "st_force",
                   "energy")

# Roofline of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: float32 operations per pair within the support, counted from the
#: kernels' inner loops (an FMA is 2; sqrt, min/max and a divide 1 each):
#: differences and r^2 8, sqrt 1, the kernel weight 8 and its sum 2
#: (density); differences, r^2, sqrt and t^3 14, v_ij.x_ij 8, viscosity 6,
#: the scale 4 and three sums 6 (accel); the continuity bracket with
#: delta-SPH diffusion 7 and its sum 3 more (accel_drho).  XSPH adds 16
#: to a momentum pass (W from its t 5, the weight and its divide 2, three
#: differences 3, three sums 6); the energy pass is the acceleration's 38
#: less its three sums (6) plus one (2); the normals: differences and r^2
#: 8, sqrt 1, t^3 5, the divide 1, three sums 6; the force: differences
#: and r^2 8 and the support test 1, K_ij 2, the normal differences 3
#: and their three sums 6 on every candidate (its curvature term has no
#: kernel weight), and sqrt 1, u 1, the spline 9, its divide by max(r) 3
#: and the three cohesion sums 6 on the pairs within the support (the
#: cohesion term is 0 past it).
FLOP_PER_PAIR = {"density": 19, "accel": 38, "accel_drho": 48,
                 "accel_xsph": 54, "accel_drho_xsph": 64, "energy": 34,
                 "st_normals": 21, "st_force": 20}
#: float32 operations per candidate (live centre, live slot of its 27
#: cells) of the passes that do work beyond the support
FLOP_PER_CANDIDATE = {"st_force": 20}
#: float32 input planes a pass reads of each slot
PLANES_READ = {"density": 3, "st_normals": 4, "st_force": 7}
#: output planes of each pass
OUT_PLANES = {"density": 1, "accel": 3, "accel_drho": 4, "accel_xsph": 6,
              "accel_drho_xsph": 7, "energy": 1, "st_normals": 3,
              "st_force": 3}

#: registers a thread of the nine kernels' instances took before the
#: option passes came (ptxas -v on the card); phase 2 fails if they change
EXISTING_REGISTERS = {
    "density_pairs_kernel<false>": 40,
    "density_pairs_kernel<true>": 48,
    "accel_pairs_kernel<false, false, 0>": 56,
    "accel_pairs_kernel<true, false, 0>": 56,
    "accel_pairs_kernel<false, true, 0>": 64,
    "accel_pairs_kernel<true, true, 0>": 64,
}
_INSTANCE = re.compile(
    r"(density_pairs_kernel|accel_pairs_kernel|st_normals_kernel|"
    r"st_force_kernel)I((?:L[bi]\d+E)+)E")


def ptxas_instances(log):
    """``{instance: (registers, spill store bytes)}`` of every kernel
    instance in the compiler's ``-Xptxas -v`` output, instances named as
    in the source (``accel_pairs_kernel<true, false, 1>``)."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            inst = _INSTANCE.search(m.group(1))
            name, spill = None, 0
            if inst:
                args = re.findall(r"L([bi])(\d+)E", inst.group(2))
                name = "%s<%s>" % (inst.group(1), ", ".join(
                    ("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def phase_registers(log):
    """Phase 2: the registers and spills of every instance; fails if an
    instance of the nine kernels changed its registers, or any spills."""
    inst = ptxas_instances(log)
    for name in sorted(inst):
        regs, spill = inst[name]
        print("phase 2: %-40s %3d registers, %d bytes spill stores"
              % (name, regs, spill))
    missing = sorted(set(EXISTING_REGISTERS) - set(inst))
    changed = {k: (inst[k][0], v) for k, v in EXISTING_REGISTERS.items()
               if k in inst and inst[k][0] != v}
    spills = sorted(k for k, (_, sp) in inst.items() if sp)
    if missing or changed or spills or len(inst) != 16:
        raise AssertionError(
            "ptxas: %d instances; missing %s; registers changed (now, "
            "before) %s; spilling %s" % (len(inst), missing, changed, spills))
    print("phase 2: the nine kernels' instances kept their registers; no "
          "instance spills")


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


def jittered(db, dev, seed=0):
    """The dam break's positions with a seeded jitter of 5% of the spacing
    and N(0, 1) velocities (so the viscosity and continuity terms are
    on)."""
    rng = np.random.default_rng(seed)
    x0 = db.state.x.cpu().numpy()
    spacing = db.params.h / 1.3
    x = x0 + (0.05 * spacing) * rng.standard_normal(x0.shape).astype(np.float32)
    v = rng.standard_normal(x0.shape).astype(np.float32)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(v).to(dev))


def finish_density(rho, mask, params):
    """Density and pressure as the step finishes them: floored on live
    slots, ``rho0`` and ``p = 0`` on dead ones."""
    rho = torch.where(mask, torch.clamp(rho, min=0.1 * params.rho0), params.rho0)
    return rho, torch.where(mask, tait_pressure(rho, params), 0.0)


def spill_inputs(db, k, dev, seed=0):
    """Both tiers of the spill layout of the jittered dam break at
    capacity ``k``, plus finished density and pressure."""
    x, v = jittered(db, dev, seed)
    grid = db.grid._replace(capacity=k)
    cells, sp = build_cells_spill(x, grid, k)
    xv = torch.cat([x, v], dim=-1)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    c = grid.n_cells
    ma, mb = cells.mask[:c].contiguous(), sp.mask[:c].contiguous()
    rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, db.params)
    ra, pa = finish_density(rho[0], ma, db.params)
    rb, pb = finish_density(rho[1], mb, db.params)
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
    break at K = 24 (spill tier occupied) and K = 32 (the flagship), then
    each two-tier role on the periodic workloads' ghost tiers
    (:func:`phase_periodic_roles`); returns per-role errors and the dam
    break's inputs by K."""
    params = db.params
    # per role: the largest raw error of any output plane, the largest
    # error scaled by its plane's max, and the raw errors by plane group
    errs = {key: {"abs": 0.0, "scaled": 0.0, "planes": {}}
            for _, key, _, _ in KERNELS[:9] if not key.endswith("_wide")}
    errs.update(option_errs())
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
        hold_roles(errs, "K=%d" % k, grid, params, a, b, options=True)
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
    phase_periodic_roles(dev, errs)
    for key, rec in errs.items():
        if key.endswith("_wide"):  # held in the wide phase
            continue
        if not rec["planes"]:
            raise AssertionError("%s was not held" % key)
        print("phase 3: %s max abs err %s, largest scaled by its plane's max "
              "%.3e" % (key, ", ".join("%s %.6g" % kv for kv in
                                       sorted(rec["planes"].items())),
                        rec["scaled"]))
    torch.cuda.synchronize()
    return errs, inputs


def hold_roles(errs, tag, grid, params, a, b, options=False):
    """Each two-tier role on tiers ``a`` and ``b`` (``(x, v, rho, p,
    mask)``, ``grid`` as the kernels receive it) against its plain
    version: self (A <- A) and cross (A <- B, B <- A), at the T of
    ``ops.tile_cells``, and with ``options`` those of the option passes
    (:func:`hold_option_roles`); updates the per-role records ``errs``."""
    roles = [
        ("density_self", 1e-5, 1e-6,
         lambda c, n, cross: ops.density_pairs(
             c[0], c[4], n[0], n[4], grid, params, cross=cross),
         lambda c, n: ops.density_pairs_plain(
             c[0], c[4], n[0], n[4], grid, params)),
        ("accel_self", 1e-4, 1e-5,
         lambda c, n, cross: ops.accel_pairs(
             *c, *n, grid, params, cross=cross),
         lambda c, n: ops.accel_pairs_plain(*c, *n, grid, params)),
        ("accel_drho_self", 1e-4, 1e-5,
         lambda c, n, cross: ops.accel_drho_pairs(
             *c, *n, grid, params, delta_sph=DELTA_SPH, cross=cross),
         lambda c, n: ops.accel_drho_pairs_plain(
             *c, *n, grid, params, delta_sph=DELTA_SPH)),
    ]
    for key, rtol, atol, kern, plain in roles:
        for cen, nbr, cross in ((a, a, False), (a, b, True), (b, a, True)):
            if not bool(cen[4].any()):
                continue
            role = key.replace("self", "cross") if cross else key
            hold_planes(errs[role], "%s %s" % (role, tag), kern(cen, nbr, cross),
                        plain(cen, nbr), cen[4], rtol, atol)
    if options:
        hold_option_roles(errs, tag, grid, params, a, b)


#: plane groups of the option passes' outputs
OPTION_GROUPS = {"accel_xsph": ("acc",) * 3 + ("dv",) * 3,
                 "accel_drho_xsph": ("acc",) * 3 + ("drho",) + ("dv",) * 3,
                 "st_normals": ("n",) * 3, "st_force": ("acc",) * 3,
                 "energy": ("du",)}


def complete_normals(a, b, grid, params):
    """``{id(tier): normals}`` of tiers ``a`` and ``b`` (``b`` may be
    ``a``), each from its own and the other tier's neighbours, as the
    force launches take them (computed by the normals kernel)."""
    normals = {}
    for t, other in ((a, b), (b, a)) if b is not a else ((a, a),):
        n = ops.st_normals_pairs(t[0], t[4], t[0], t[2], t[4], grid, params)
        if other is not t:
            n = n + ops.st_normals_pairs(t[0], t[4], other[0], other[2],
                                         other[4], grid, params, cross=True)
        normals[id(t)] = n
    return normals


def option_errs():
    """Empty error records of every role of the option passes."""
    return {"%s_%s" % (f, r): {"abs": 0.0, "scaled": 0.0, "planes": {}}
            for f in OPTION_FAMILIES for r in ("self", "cross", "wide")}


def hold_option_roles(errs, tag, grid, params, a, b):
    """Each role of the option passes on tiers ``a`` and ``b`` (``(x, v,
    rho, p, mask)``) against its plain version at rtol 1e-4, atol 1e-5,
    each plane scaled by its max: self (A <- A) and cross (A <- B,
    B <- A), or the wide roles when ``grid`` is past 64 slots (``a`` is
    ``b`` then).  The XSPH instances' acceleration (and drho/dt) planes
    must be bit-identical to those of the instances without XSPH (held
    by the nine roles), so only their XSPH planes meet the plain XSPH
    pass; the force passes take the complete normals (both tiers')."""
    wide = grid.capacity > ops.MAX_CAPACITY
    roles = ([(a, a, False)] if wide or a is b
             else [(a, a, False), (a, b, True), (b, a, True)])
    normals = complete_normals(a, b, grid, params)
    for cen, nbr, cross in roles:
        if not bool(cen[4].any()):
            continue
        role = "wide" if wide else "cross" if cross else "self"
        kw = {"cross": cross}
        xsph_plain = ops.xsph_pairs_plain(*cen, *nbr, grid, params)
        nc, nn = normals[id(cen)], normals[id(nbr)]
        cases = [
            ("accel_xsph", ops.accel_pairs(*cen, *nbr, grid, params,
                                           xsph=True, **kw),
             ops.accel_pairs(*cen, *nbr, grid, params, **kw), xsph_plain),
            ("accel_drho_xsph", ops.accel_drho_pairs(
                *cen, *nbr, grid, params, delta_sph=DELTA_SPH, xsph=True,
                **kw),
             ops.accel_drho_pairs(*cen, *nbr, grid, params,
                                  delta_sph=DELTA_SPH, **kw), xsph_plain),
            ("st_normals", ops.st_normals_pairs(
                cen[0], cen[4], nbr[0], nbr[2], nbr[4], grid, params, **kw),
             None, ops.st_normals_pairs_plain(
                 cen[0], cen[4], nbr[0], nbr[2], nbr[4], grid, params)),
            ("st_force", ops.st_force_pairs(
                cen[0], nc, cen[2], cen[4], nbr[0], nn, nbr[2], nbr[4], grid,
                params, OPTIONS["surface_tension"], **kw),
             None, ops.st_force_pairs_plain(
                 cen[0], nc, cen[2], cen[4], nbr[0], nn, nbr[2], nbr[4],
                 grid, params, OPTIONS["surface_tension"])),
            ("energy", ops.energy_pairs(*cen, *nbr, grid, params, **kw),
             None, ops.energy_pairs_plain(*cen, *nbr, grid, params)),
        ]
        for family, got, base, want in cases:
            key = "%s_%s" % (family, role)
            groups = OPTION_GROUPS[family]
            if base is not None:
                n_base = base.shape[0]
                if not torch.equal(got[:n_base], base):
                    raise AssertionError(
                        "%s %s: the XSPH instance changed the other planes"
                        % (key, tag))
                got, groups = got[n_base:], groups[n_base:]
            hold_planes(errs[key], "%s %s" % (key, tag), got, want, cen[4],
                        1e-4, 1e-5, groups)


def periodic_roles_inputs(sc, grid, dev, seed=0):
    """The ghost tiers a periodic step hands the two-tier kernels for the
    scenario ``sc`` on ``grid``: its positions jittered by 5% of the
    spacing (in-plane for 2-D, wrapped into the box) with N(0, 1)
    velocities (in-plane for 2-D), both tiers of the spill layout with
    finished density and pressure (the plain wrapped density), expanded
    by the ghost halo as ``ops._two_tier`` expands them.  Returns
    ``{"grid": ghost grid, "a": ..., "b": ...}`` as :func:`spill_inputs`
    does, and ``"spill"``, the particles in the spill tier."""
    rng = np.random.default_rng(seed)
    params, dim, k = sc.params, sc.params.dim, grid.capacity
    x0 = sc.state.x.cpu().numpy().astype(np.float64)
    box = np.asarray(sc.box, np.float64)
    x, v = x0.copy(), np.zeros_like(x0)
    x[:, :dim] = np.mod(x0[:, :dim] + (0.05 * params.h / 1.3)
                        * rng.standard_normal((x0.shape[0], dim)), box)
    v[:, :dim] = rng.standard_normal((x0.shape[0], dim))
    # np.mod may round up to the box's edge in float32
    x = x.astype(np.float32)
    x[:, :dim] = np.minimum(x[:, :dim], np.nextafter(
        box.astype(np.float32), np.float32(0)))
    x = torch.from_numpy(x).to(dev)
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    cells, sp = build_cells_spill(x, grid, k)
    if int(cells.overflow):
        raise AssertionError("overflow in the periodic inputs at K=%d" % k)
    xv = torch.cat([x, v], dim=-1)
    a = scatter_to_cells_soa(xv, cells, grid)
    b = scatter_to_cells_soa(xv, cells, grid, slot_base=k, capacity=k)
    c = grid.n_cells
    ma, mb = cells.mask[:c].contiguous(), sp.mask[:c].contiguous()
    wrap = ops._wrapped(wrap_axes(grid, True))
    rho = ops.density_spill_plain(a[:3], ma, b[:3], mb, grid, params,
                                  wrap_axes=wrap)
    ra, pa = finish_density(rho[0], ma, params)
    rb, pb = finish_density(rho[1], mb, params)
    g, src, shift, _ = ops._ghost_index(grid, wrap, dev)
    return {
        "grid": g,
        "a": ops._ghost_tier((a[:3], a[3:], ra, pa, ma), src, shift),
        "b": ops._ghost_tier((b[:3], b[3:], rb, pb, mb), src, shift),
        "spill": int(mb.sum()),
    }


def phase_periodic_roles(dev, errs):
    """Phase 3 (periodic): each two-tier role on the ghost tiers of the
    periodic workloads at their own grids, K and T: the 1M still box
    (K from "auto", clamped to 24-64 as :func:`configuration` does; the
    option passes' roles too) and the 2-D Taylor-Green vortex of phase 4
    (nz = 1, its own K)."""
    box = still_box(n_side=N_BOX_1M, capacity="auto", device=dev)
    vortex = taylor_green(n_side=N_VORTEX, device=dev)
    for name, sc, grid in (
        ("still box", box,
         box.grid._replace(capacity=min(max(box.grid.capacity, 24), 64))),
        ("taylor_green", vortex, vortex.grid),
    ):
        s = periodic_roles_inputs(sc, grid, dev)
        g, a, b = s["grid"], s["a"], s["b"]
        tag = "%s ghost grid %s K=%d" % (name, "x".join(map(str, g.dims)),
                                         g.capacity)
        hold_roles(errs, tag, g, sc.params, a, b, options=name == "still box")
        print("phase 3 (periodic): %s, N=%d, %d in the spill tier (%s; "
              "momentum %d B): every two-tier role held"
              % (tag, sc.n, s["spill"], tile_note("density", g, sc.params),
                 ops.tile_shared_bytes("accel", g, sc.params)))


def timed(fn):
    """``(fn(), device milliseconds)`` of one run (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def hold_planes(rec, name, got, want, live, rtol, atol, groups=None):
    """Every output plane of ``got`` against ``want`` on live slots, each
    scaled by its own max; dead slots must be exactly 0.  Updates the
    role's error record ``rec``, by plane group (``groups``: the name of
    each plane; by default rho, or acc and drho)."""
    if bool(got[..., ~live].any()):
        raise AssertionError("%s: nonzero output on a dead centre slot" % name)
    planes = [(got, want)] if got.dim() == 2 else zip(got, want)
    for i, (g, w) in enumerate(planes):
        if not bool(w.any()):
            if bool(g.any()):
                raise AssertionError("%s: nonzero plane %d" % (name, i))
            continue
        e = check_scaled("%s plane %d" % (name, i), g, w, live, rtol, atol)
        if groups is not None:
            group = groups[i]
        else:
            group = "rho" if got.dim() == 2 else "drho" if i == 3 else "acc"
        rec["abs"] = max(rec["abs"], e)
        rec["scaled"] = max(rec["scaled"], e / float(w[live].abs().max()))
        rec["planes"][group] = max(rec["planes"].get(group, 0.0), e)


def single_tier_inputs(db, k, dev, permute=False, seed=0):
    """The single-tier layout ``(grid, x, v, mask)`` of the jittered dam
    break at capacity ``k``; ``permute`` shuffles the slots of every cell,
    which turns the prefix masks into arbitrary ones."""
    x, v = jittered(db, dev, seed)
    grid = db.grid._replace(capacity=k)
    cells = build_cells(x, grid)
    if int(cells.overflow):
        raise AssertionError("overflow at K=%d" % k)
    soa = scatter_to_cells_soa(torch.cat([x, v], dim=-1), cells, grid)
    m = cells.mask[: grid.n_cells].contiguous()
    if permute:
        gen = torch.Generator(device=dev).manual_seed(seed)
        perm = torch.rand(m.shape, device=dev, generator=gen).argsort(dim=1)
        m = torch.gather(m, 1, perm)
        soa = torch.gather(soa, 2, perm.expand(6, -1, -1)).contiguous()
        if bool(m[:, 0].all()):
            raise AssertionError("the permuted masks are still prefixes")
    return grid, soa[:3], soa[3:], m


def phase_wide_kernels_vs_plain(dev, card):
    """Phase 3 (wide): the three wide roles against their plain versions
    on the 1M dam break at K = 128 (both smoothing kernels, delta-SPH on
    and off; each plain pass runs once and is timed), then at 100k
    particles K = 96 and 256 and, at K = 128, an arbitrary mask, then on
    the 1M still box's ghost grid (:func:`phase_periodic_wide_roles`).
    Returns the per-role errors, the 1M tier and the plain passes'
    times."""
    errs = {key: {"abs": 0.0, "scaled": 0.0, "planes": {}}
            for key in ("density_wide", "accel_wide", "accel_drho_wide")}
    errs.update({k: v for k, v in option_errs().items()
                 if k.endswith("_wide")})
    plain_ms = {}
    tier1m = None
    cases = [(N_1M, K_WIDE, False), (N_100K, 96, False), (N_100K, 256, False),
             (N_100K, K_WIDE, True)]
    for n_side, k, permute in cases:
        db = dam_break(n_side=n_side, capacity=k, device=dev)
        params = db.params
        grid, x, v, m = single_tier_inputs(db, k, dev, permute)
        full = n_side == N_1M
        tag = "phase 3 (wide): N=%d K=%d%s" % (
            db.n, k, ", arbitrary mask" if permute else "")
        # K = 256 costs 64 times the plain pairs of K = 32: one kernel there
        kernels = (WendlandC2,) if k == 256 else (WendlandC2, CubicSpline)
        for kern in kernels:
            name = "%s %s" % (tag, kern.__name__)
            got = ops.density(x, m, grid, params, kernel=kern)
            want, ms = timed(
                lambda: ops.density_plain(x, m, grid, params, kernel=kern))
            hold_planes(errs["density_wide"], name + " density", got, want, m,
                        1e-5, 1e-6)
            tier = (x, v, *finish_density(want, m, params), m)
            if full and kern is WendlandC2:
                plain_ms["density_wide"], tier1m = ms, (grid, params, tier)
            if not (full and kern is CubicSpline):  # held by accel_drho there
                got = ops.accel(*tier, grid, params, kernel=kern)
                want, ms = timed(
                    lambda: ops.accel_plain(*tier, grid, params, kernel=kern))
                hold_planes(errs["accel_wide"], name + " accel", got, want, m,
                            1e-4, 1e-5)
                if full:
                    plain_ms["accel_wide"] = ms
            for delta in (DELTA_SPH, 0.0):
                if delta == 0.0 and not (full and kern is WendlandC2):
                    continue
                kw = {"kernel": kern, "delta_sph": delta}
                got = ops.accel_drho(*tier, grid, params, **kw)
                want, ms = timed(
                    lambda: ops.accel_drho_plain(*tier, grid, params, **kw))
                hold_planes(errs["accel_drho_wide"],
                            "%s accel_drho delta=%g" % (name, delta), got,
                            want, m, 1e-4, 1e-5)
                if full and kern is WendlandC2 and delta:
                    plain_ms["accel_drho_wide"] = ms
        if n_side == N_100K and k == K_WIDE:
            # the option passes' wide roles, on the arbitrary masks (at
            # 100k: their plain passes at 1M take seconds each)
            hold_option_roles(errs, tag, grid, params, tier, tier)
            n_options = db.n
        print("%s: %d live slots of %d, %.1f%% of the cells past 32 slots; "
              "held" % (tag, int(m.sum()), m.numel(),
                        100.0 * float(m[:, 32:].any(dim=1).float().mean())))
    phase_periodic_wide_roles(dev, errs)
    for key, rec in errs.items():
        if key not in plain_ms:  # an option pass's role
            if not rec["planes"]:
                raise AssertionError("%s was not held" % key)
            print("phase 3 (wide): %s max abs err %s, largest scaled by its "
                  "plane's max %.3e (N=%d, K=%d, arbitrary mask)"
                  % (key, ", ".join("%s %.6g" % kv for kv in
                                    sorted(rec["planes"].items())),
                     rec["scaled"], n_options, K_WIDE))
            continue
        print("phase 3 (wide): %s max abs err %s, largest scaled by its "
              "plane's max %.3e; plain pass %.1f ms [%s]"
              % (key, ", ".join("%s %.6g" % kv for kv in
                                sorted(rec["planes"].items())),
                 rec["scaled"], plain_ms[key], card))
    return errs, tier1m, plain_ms


def phase_periodic_wide_roles(dev, errs):
    """Phase 3 (wide, periodic): each single-tier role past 64 slots on
    the ghost tier a periodic wide step hands the kernels: the 1M still
    box at K = 128, jittered, with N(0, 1) velocities; updates the wide
    roles' records ``errs``."""
    sc = still_box(n_side=N_BOX_1M, capacity=K_WIDE, device=dev)
    s = periodic_roles_inputs(sc, sc.grid, dev)
    if s["spill"]:
        raise AssertionError("the K=128 still box spilled")
    g, t, params = s["grid"], s["a"], sc.params
    tag = "still box ghost grid %s K=%d" % ("x".join(map(str, g.dims)),
                                            g.capacity)
    hold_planes(errs["density_wide"], tag + " density",
                ops.density_pairs(t[0], t[4], t[0], t[4], g, params),
                ops.density_pairs_plain(t[0], t[4], t[0], t[4], g, params),
                t[4], 1e-5, 1e-6)
    hold_planes(errs["accel_wide"], tag + " accel",
                ops.accel_pairs(*t, *t, g, params),
                ops.accel_pairs_plain(*t, *t, g, params), t[4], 1e-4, 1e-5)
    hold_planes(errs["accel_drho_wide"], tag + " accel_drho",
                ops.accel_drho_pairs(*t, *t, g, params, delta_sph=DELTA_SPH),
                ops.accel_drho_pairs_plain(*t, *t, g, params,
                                           delta_sph=DELTA_SPH),
                t[4], 1e-4, 1e-5)
    print("phase 3 (wide, periodic): %s, N=%d (%s): every wide role held"
          % (tag, sc.n, tile_note("accel", g, params)))


#: the main paths: chunks of a frame and launches per step, by layout
#: ("" is the flagship two-tier spill layout, "wide " the single tier at
#: K = 128) and density mode; a continuity path also launches the density
#: kernel once (per role and tier pass) when its carried density is seeded
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
    "wide summation": {
        "chunks": ("position", "velocity", "density", "pressure", "slength"),
        "per_step": {"density_wide": 1, "accel_wide": 1},
        "seed": {},
    },
    "wide continuity": {
        "chunks": ("position", "velocity", "density"),
        "per_step": {"accel_drho_wide": 1},
        "seed": {"density_wide": 1},
    },
    # with OPTIONS: XSPH rides the momentum launches; surface tension adds
    # the normals and force passes (4 + 4 launches a step on two tiers)
    "options summation": {
        "chunks": ("position", "velocity", "density", "pressure", "slength"),
        "per_step": {"density_self": 2, "density_cross": 2,
                     "accel_xsph_self": 2, "accel_xsph_cross": 2,
                     "st_normals_self": 2, "st_normals_cross": 2,
                     "st_force_self": 2, "st_force_cross": 2},
        "seed": {},
        "steps": 10,
    },
    "options continuity": {
        "chunks": ("position", "velocity", "density"),
        "per_step": {"accel_drho_xsph_self": 2, "accel_drho_xsph_cross": 2,
                     "st_normals_self": 2, "st_normals_cross": 2,
                     "st_force_self": 2, "st_force_cross": 2},
        "seed": {"density_self": 2, "density_cross": 2},
        "steps": 10,
    },
    "wide options summation": {
        "chunks": ("position", "velocity", "density", "pressure", "slength"),
        "per_step": {"density_wide": 1, "accel_xsph_wide": 1,
                     "st_normals_wide": 1, "st_force_wide": 1},
        "seed": {},
        "steps": 10,
    },
    "wide options continuity": {
        "chunks": ("position", "velocity", "density"),
        "per_step": {"accel_drho_xsph_wide": 1, "st_normals_wide": 1,
                     "st_force_wide": 1},
        "seed": {"density_wide": 1},
        "steps": 10,
    },
}


PATHS_MODES = ("summation", "continuity")


def configuration(layout, n_side, dev, density_mode, plain=False,
                  options=None, adaptive=False):
    """``(step, state)`` of one of the driven configurations through the
    entry points a user calls, with the "auto" policies (``plain``: the
    plain pair passes instead: on the single tier, which for the periodic
    two-tier layout is the slot-identical tier of twice the capacity; for
    the flagship the plain spill ops on its own grid; ``options``: more
    ``make_step_fn`` arguments, the flagship then built as ``entry``
    builds it; ``adaptive``: the step of ``make_adaptive_step_fn`` on the
    same grid, ``step(state, dt) -> (state, aux, dt_next)``):

    * ``"spill"``: the flagship, dam break on the two-tier layout;
    * ``"wide"``: the dam break on the single tier at K = 128;
    * ``"periodic spill"`` / ``"periodic wide"``: the periodic still box,
      capacity from ``"auto"`` clamped to 24-64 as ``entry`` does, or 128.
    """
    if layout == "spill" and not (plain or options or adaptive):
        step, (state,) = entry(n_side=n_side, device=dev,
                               density_mode=density_mode)
        return step, state
    periodic = layout.startswith("periodic")
    wide = layout.endswith("wide")
    if periodic:
        sc = still_box(n_side=n_side, capacity=K_WIDE if wide else "auto",
                       device=dev)
    elif wide:
        sc = dam_break(n_side=n_side, capacity=K_WIDE, device=dev)
    else:
        sc = dam_break(n_side=n_side, capacity="auto", capacity_headroom=1.15,
                       device=dev)
    grid = sc.grid
    if not wide:
        grid = grid._replace(capacity=min(max(grid.capacity, 24), 64))
    kw = {"use_kernels": "auto", "spill": "auto"}
    if plain:
        # the flagship's plain path is the plain spill ops on its own grid
        kw = {"use_kernels": False, "spill": layout == "spill"}
        if layout == "periodic spill":
            grid = grid._replace(capacity=2 * grid.capacity)
    build = make_adaptive_step_fn if adaptive else make_step_fn
    step = build(grid, sc.params, periodic=periodic,
                 density_mode=density_mode, device=dev, **kw,
                 **(options or {}))
    want = {"use_kernels": not plain,
            "spill": layout == "spill" or not (plain or wide),
            "density_mode": density_mode}
    if step.resolved != want:
        raise AssertionError("%s resolved to %r" % (layout, step.resolved))
    state = sc.state
    if density_mode == "continuity":
        state = init_density(state, grid, sc.params, periodic=periodic,
                             device=dev)
    return step, state


def phase_main_path(dev, card, params, path):
    """Phase 4: one main path (a key of ``PATHS``) at the 1M dam break
    through the entry points, 20 steps, a frame every 5th step through the
    async dump into the port's writer; returns the launch counts of the
    whole path (seed included)."""
    path_of = PATHS[path]
    tag = "phase 4 (%s)" % path
    density_mode = path.split()[-1]
    layout = "wide" if path.startswith("wide") else "spill"
    options = OPTIONS if "options" in path else None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    step, state = configuration(layout, N_1M, dev, density_mode,
                                options=options)
    want = {"use_kernels": True, "spill": layout == "spill",
            "density_mode": density_mode}
    if step.resolved != want:
        raise AssertionError("%s resolved to %r" % (path, step.resolved))
    n = state.x.shape[0]
    if n != N_1M_PARTICLES:
        raise AssertionError("1M dam break has %d particles" % n)
    slength = torch.full((n,), params.h, device=dev)
    n_steps, every = path_of.get("steps", 20), 5

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dam_break.gsd")
        writer = ShardedFrameWriter(
            path, application="tpgsd_torch.chip_smoke", comm=SingleComm(),
            static={"configuration/box": BOX},
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
            "ms/step incl. dump), dump %.1f MB/s while writing [%s]"
            % (tag, n_steps, n, stats.frames, len(path_of["chunks"]), wall,
               1e3 * wall / n_steps, stats.write_mb_s, card)
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
        print("%s: launch counts %s (every other role 0)" % (
            tag, json.dumps({k: v for k, v in counts.items() if v})))
        # the row kernel: one launch a step's finish, one the seed's
        rows = ops.row_launch_counts["slot_rows"]
        want_rows = n_steps + (density_mode == "continuity")
        if rows != want_rows:
            raise AssertionError("slot_rows launched %d times in %d steps "
                                 "(expected %d)" % (rows, n_steps, want_rows))
        print("%s: slot_rows launched %d times (%d steps and %d seed)"
              % (tag, rows, n_steps, want_rows - n_steps))
        counts["slot_rows"] = rows

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


def row_bound_ms(rows, n_cols):
    """The row kernel's byte bound: a row's cell id, slot and ``order``
    entry (int64 each) and its ``n_cols`` columns read, and the columns
    written, over the HBM bandwidth."""
    n_bytes = rows * (24 + 8 * n_cols)
    return 1e3 * n_bytes / HBM_BYTES_PER_S, n_bytes


def capture_rows(name, run, rank=lambda a: 0):
    """``(calls, (args, kwargs))``: the number of ``ops.<name>`` calls
    that ``run()`` made, which runs unchanged, and the arguments of the
    first call of the highest ``rank(args)`` (only that call's tensors
    are kept)."""
    real, seen = getattr(ops, name), {"calls": 0}

    def spy(*a, **kw):
        r = rank(a)
        if "best" not in seen or r > seen["rank"]:
            seen.update(best=(a, kw), rank=r)
        seen["calls"] += 1
        return real(*a, **kw)

    setattr(ops, name, spy)
    try:
        run()
    finally:
        setattr(ops, name, real)
    return seen["calls"], seen.get("best")


def phase_rows(dev, card):
    """Phase 4b: ``slot_rows_kernel`` against its twin
    (``ops.slot_rows_plain``) bit for bit on the row call of one 1M step's
    finish, the spill summation step (5 columns, timed beside its byte
    bound) and the spill continuity step with the options (7 columns)."""
    for mode, options in (("summation", None), ("continuity", OPTIONS)):
        step, state = configuration("spill", N_1M, dev, mode,
                                    options=options)
        calls, (a, kw) = capture_rows("slot_rows", lambda: step(state))
        if calls != 1:
            raise AssertionError("%d row calls in a step" % calls)
        kw = dict(kw, plain=False)
        got = ops.slot_rows(*a, **kw)
        want = ops.slot_rows(*a, **dict(kw, plain=True))
        n, f = got.shape
        if not (got.dtype == want.dtype == torch.float32
                and got.shape == want.shape
                and torch.equal(got.view(torch.int32),
                                want.view(torch.int32))):
            raise AssertionError("slot_rows %s at N=%d differs from its twin"
                                 % (mode, n))
        tag = "phase 4b (rows, 1M spill %s%s)" % (
            mode, " with %s" % json.dumps(options) if options else "")
        if options is None:
            kms = cuda_ms(lambda: ops.slot_rows(*a, **kw), 20, 3)
            pms = cuda_ms(lambda: ops.slot_rows(*a, **dict(kw, plain=True)),
                          5, 1)
            bound, n_bytes = row_bound_ms(n, f)
            ROW_TIMES["1M"] = {"ms": kms, "plain_ms": pms, "bound_ms": bound}
            print("%s: slot_rows bit-equal to its twin, N=%d rows of %d "
                  "columns, %d tiers of K=%d; kernel %.4f ms, twin %.4f ms, "
                  "bound %.4f ms by bytes (%.4g bytes; kernel at %.1f%% of "
                  "the bound's rate) [%s]"
                  % (tag, n, f, len(a[0]), a[0][0][0].shape[1], kms, pms,
                     bound, n_bytes, 100.0 * bound / kms, card))
        else:
            print("%s: slot_rows bit-equal to its twin, N=%d rows of %d "
                  "columns [%s]" % (tag, n, f, card))
        del step, state, calls, a, kw, got, want


def hold_slab_rows(step, state, grid, n_slabs, card):
    """Phase 9: ``slot_rows_kernel`` against its twin on the window of the
    1e8 step's most populated slab, bit for bit (the particle rows it
    writes and its window-order rows), timed beside the byte bound of the
    slab's own rows."""
    calls, (a, kw) = capture_rows(
        "window_rows", lambda: step(state),
        lambda a: int(a[7] - a[6]))  # the slab's own rows (a host sync)
    if calls != n_slabs:
        raise AssertionError("%d window calls in a step" % calls)
    # a[11] is the offset of the domain's first cell, _PAD - s nxl planes
    s = (_PAD - a[11][0]) // (grid.dims[0] // n_slabs)
    own = int(a[7] - a[6])
    n_rows = int(a[8])
    tiers, fill, out = a[0], a[1], a[2]
    n, f = out.shape
    rest = a[3:]
    got = out.new_zeros((n, f))
    want = out.new_zeros((n, f))
    win = ops.window_rows(tiers, fill, got, *rest,
                          **dict(kw, emit=True, plain=False))
    win_p = ops.window_rows(tiers, fill, want, *rest,
                            **dict(kw, emit=True, plain=True))
    for name, x, y in (("particle rows", got, want), ("window", win, win_p)):
        if not (x.shape == y.shape and torch.equal(x.view(torch.int32),
                                                   y.view(torch.int32))):
            raise AssertionError("1e8 slab %d: the row kernel's %s differ "
                                 "from its twin" % (s, name))
    del win, win_p, want
    silent = dict(kw, emit=False)
    kms = cuda_ms(lambda: ops.window_rows(tiers, fill, got, *rest,
                                          **dict(silent, plain=False)), 10, 2)
    pms = cuda_ms(lambda: ops.window_rows(tiers, fill, got, *rest,
                                          **dict(silent, plain=True)), 3, 1)
    bound, n_bytes = row_bound_ms(own, f)
    ROW_TIMES["1e8 window"] = {"ms": kms, "plain_ms": pms, "bound_ms": bound,
                               "rows": own, "window": n_rows}
    print("phase 9 (1e8 rows): slot_rows on slab %d of %d, the most "
          "populated (%d own rows, a window of %d, %d columns, %d tiers), "
          "bit-equal to its twin, particle rows and window rows; kernel "
          "%.4f ms, twin %.4f ms, bound %.4f ms by bytes (%.4g bytes of the "
          "slab's own rows; kernel at %.1f%% of the bound's rate) [%s]"
          % (s, n_slabs, own, n_rows, f, len(tiers), kms, pms, bound,
             n_bytes, 100.0 * bound / kms, card))
    del got, tiers, a, kw


def row_kernel_entry(counts, slab_counts):
    """The row kernel's entry of the ``kernels`` line: launches on the
    1M summation main path (20 steps) and in the 1e8 cycle's 4 silent
    summation steps, times from phases 4b and 9."""
    one_m, window = ROW_TIMES["1M"], ROW_TIMES["1e8 window"]
    return {
        "name": "slot_rows",
        "route": "cuda",
        "source": "tpgsd_torch/csrc/slot_rows.cu",
        "replaces": "jnp: the per-slot bundle concatenation and the "
                    "inverse-permutation gather of the step's finish",
        "launches": counts["summation"]["slot_rows"],
        "slab_launches": slab_counts["slot_rows"],
        "max_abs_err": 0.0,
        "max_scaled_err": 0.0,
        "ms": one_m["ms"],
        "plain_ms": one_m["plain_ms"],
        "bound_ms": one_m["bound_ms"],
        "bound_by": "bytes",
        "window_ms": window["ms"],
        "window_plain_ms": window["plain_ms"],
        "window_bound_ms": window["bound_ms"],
        "library_ms": None,
    }


def moving_state(state, dev, seed=5, scale=0.1):
    """``state`` with seeded N(0, scale^2) velocities added."""
    rng = np.random.default_rng(seed)
    dv = scale * rng.standard_normal(tuple(state.v.shape)).astype(np.float32)
    return state._replace(v=state.v + torch.from_numpy(dv).to(dev))


def energy_rate_plain(state, grid, params):
    """``energy_rate`` through the plain pair passes on the same device:
    the single tier, summation density floored at 0.1 rho0, the energy
    pass."""
    c = grid.n_cells
    cells = build_cells(state.x, grid)
    xv = scatter_to_cells_soa(torch.cat([state.x, state.v], -1), cells, grid)
    m = cells.mask[:c]
    rho = finish_density(ops.density_plain(xv[:3], m, grid, params), m, params)
    du = ops.energy_plain(xv[:3], xv[3:], *rho, m, grid, params)
    return gather_from_cells(torch.cat([du, du.new_zeros((1, du.shape[1]))]),
                             cells, grid)


def phase_energy_rate(dev, card):
    """Phase 4 (energy_rate): ``energy_rate`` of the 1M dam break with
    seeded N(0, 0.01) velocities on the flagship's grid (K = 32: the self
    roles) and on the single tier at K = 128 (the wide roles): finite,
    ``[N]``, its launches counted exactly (one density and one energy
    launch); at K = 32 it is held against the plain passes (rtol 1e-4,
    atol 1e-5 scaled).  Returns the launch counts by path and the
    device milliseconds of each (CUDA events)."""
    counts, ms = {}, {}
    for path, capacity in (("energy_rate", None), ("wide energy_rate", K_WIDE)):
        db = dam_break(n_side=N_1M, capacity=capacity or "auto",
                       capacity_headroom=1.15, device=dev)
        grid = db.grid
        if capacity is None:
            grid = grid._replace(capacity=min(max(grid.capacity, 24), 64))
        state = moving_state(db.state, dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        du = energy_rate(state, grid, db.params)
        torch.cuda.synchronize()
        counts[path] = {k: v for k, v in ops.launch_counts.items() if v}
        role = "wide" if capacity else "self"
        want = {"density_" + role: 1, "energy_" + role: 1}
        if counts[path] != want:
            raise AssertionError("%s launched %r, expected %r"
                                 % (path, counts[path], want))
        if du.shape != (db.n,) or not bool(torch.isfinite(du).all()):
            raise AssertionError("%s: malformed or non-finite du/dt" % path)
        msg = ""
        if capacity is None:
            everything = torch.ones_like(du, dtype=torch.bool)
            e = check_scaled("energy_rate K=%d" % grid.capacity, du,
                             energy_rate_plain(state, grid, db.params),
                             everything, 1e-4, 1e-5)
            msg = ", held against the plain passes (max abs err %.3g)" % e
        ms[path] = cuda_ms(lambda: energy_rate(state, grid, db.params), 10, 2)
        print("phase 4 (%s): N=%d, K=%d, launches %s, du/dt finite (max "
              "|du/dt| %.4g)%s; %.4f ms a call [%s]"
              % (path, db.n, grid.capacity, json.dumps(counts[path]),
                 float(du.abs().max()), msg, ms[path], card))
        del db, state, du
    return counts, ms


#: slack of the carried-density comparison for the rounding of rho near
#: 1000 to float32: two units in the last place at rho >= 1024
RHO_ROUNDING = 2.5e-4


def phase_kernel_vs_plain_step(dev, density_mode, layout="spill",
                               n_side=N_100K, options=None):
    """Phase 5: one step of the kernel path of a ``configuration``
    against its plain path at 100k particles (64k in the periodic box),
    from a state 10 kernel steps into the run with seeded
    N(0, 0.1) velocities on top (so v_ij.x_ij, the viscosity and the
    continuity sum are far from zero).  In continuity mode the CHANGE of
    the carried density is compared too, scaled by its max (rtol 1e-4,
    atol 1e-5, plus the rounding of rho itself): a step whose drho/dt was
    zero, or lacked a term, would pass a tolerance relative to rho.  The
    periodic kernel steps take the ghost halo, their plain step the
    wrapped neighbour table and the minimum image.  ``options``: more
    ``make_step_fn`` arguments for both steps (XSPH, surface tension)."""
    step_k, state = configuration(layout, n_side, dev, density_mode,
                                  options=options)
    step_p, _ = configuration(layout, n_side, dev, density_mode, plain=True,
                              options=options)
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
    print("phase 5 (%s %s%s): kernel path vs plain path at N=%d: positions "
          "within rtol 1e-5 atol 1e-6 (max abs %.3g), rho within %s (max abs "
          "err %.3g)" % (layout, density_mode,
                         " with %s" % json.dumps(options) if options else "",
                         state.x.shape[0], float((sk.x - sp.x).abs().max()),
                         rho_tol, e))
    return step_k, step_p, state


def advance(step, state, dt=None):
    """One step of a fixed step (``dt`` None) or of an adaptive one at
    ``dt``: ``(state, aux, dt_next)`` (``dt_next`` None for the fixed)."""
    if dt is None:
        return (*step(state), None)
    return step(state, dt)


def run_counted(step, state, n_steps, dt=None):
    """``n_steps`` steps (of an adaptive step each at ``dt``, not at the
    controller's choice) with the launch counts set to 0 just before;
    returns the final state, the last aux and the counts, and raises on
    overflow."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    overflow = []
    for _ in range(n_steps):
        state, aux, _ = advance(step, state, dt)
        overflow.append(aux[2])
    torch.cuda.synchronize()
    if int(torch.stack(overflow).sum()):
        raise AssertionError("overflow in a counted run")
    return state, aux, {k: v for k, v in ops.launch_counts.items() if v}


def phase_periodic(dev, card):
    """The periodic workloads at full width: the 1M still box for 10
    steps on the two-tier layout (summation and continuity) and on the
    wide layout (summation), where a periodic lattice must show no wall
    deficit (mean density within 2% of rho0, every particle within 1% of
    the mean); and the 2-D Taylor-Green vortex for 30 steps, whose kinetic
    energy must fall and whose z must not move."""
    n_steps = 10
    for layout, mode in (("periodic spill", "summation"),
                         ("periodic spill", "continuity"),
                         ("periodic wide", "summation")):
        step, state = configuration(layout, N_BOX_1M, dev, mode)
        n = state.x.shape[0]
        state, (rho, _p, _ov), counts = run_counted(step, state, n_steps)
        role = ("wide",) if layout.endswith("wide") else ("self", "cross")
        per_step = 2 if len(role) == 2 else 1
        families = ("accel_drho",) if mode == "continuity" else ("density", "accel")
        want = {"%s_%s" % (f, r): per_step * n_steps
                for f in families for r in role}
        if counts != want:
            raise AssertionError("%s %s launched %r, expected %r"
                                 % (layout, mode, counts, want))
        if not bool(torch.isfinite(state.x).all()):
            raise AssertionError("%s %s: non-finite positions" % (layout, mode))
        rho0 = 1000.0
        mean = float(rho.mean())
        spread = float((rho / mean - 1.0).abs().max())
        if abs(mean / rho0 - 1.0) > 0.02 or spread > 0.01:
            raise AssertionError(
                "%s %s: mean density %.4f, largest deviation from it %.4f: a "
                "wall deficit" % (layout, mode, mean, spread))
        print("phase 4 (%s %s): N=%d, %d steps, launches %s, mean density "
              "%.4f (rho0 %.0f), every particle within %.2e of the mean "
              "(limit 1e-2)" % (layout, mode, n, n_steps, json.dumps(counts),
                                mean, rho0, spread))

    sc = taylor_green(n_side=N_VORTEX, device=dev)
    step = make_step_fn(sc.grid, sc.params, periodic=True, device=dev)
    want = {"use_kernels": True, "spill": True, "density_mode": "summation"}
    if step.resolved != want:
        raise AssertionError("taylor_green resolved to %r" % (step.resolved,))
    state = sc.state

    def kinetic(st):
        return 0.5 * sc.params.mass * float((st.v.double() ** 2).sum())

    energy = [kinetic(state)]
    total = {}
    for _ in range(2):
        state, _aux, counts = run_counted(step, state, 15)
        energy.append(kinetic(state))
        for key, value in counts.items():
            total[key] = total.get(key, 0) + value
    if not (energy[0] > energy[1] > energy[2] > 0.0):
        raise AssertionError("taylor_green kinetic energy %r" % (energy,))
    if not torch.equal(state.x[:, 2], sc.state.x[:, 2]):
        raise AssertionError("taylor_green: z moved")
    if total != {"density_self": 60, "density_cross": 60,
                 "accel_self": 60, "accel_cross": 60}:
        raise AssertionError("taylor_green launched %r" % (total,))
    print("phase 4 (taylor_green): N=%d (2-D, grid %s, K=%d), 30 periodic "
          "steps, kinetic energy %.6g -> %.6g -> %.6g, z unchanged, launches "
          "%s" % (sc.n, "x".join(map(str, sc.grid.dims)), sc.grid.capacity,
                  energy[0], energy[1], energy[2], json.dumps(total)))


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
    for cells in _cell_blocks(mc):
        nb = nbr[cells]
        d = xc[:, cells, :, None] - _gather_nbr(xn_s, nb)
        near = torch.sum(d * d, dim=0) < supp2
        total += int((near & _gather_nbr(mn_s, nb) & mc[cells, :, None]).sum())
    return total


def count_candidates(cen, nbr_tier, grid):
    """Pairs (live centre, live neighbour slot of its 27 neighbour cells),
    within the support or not."""
    mc, mn = cen[4], nbr_tier[4]
    nbr = neighbor_index(grid, mc.device)  # [C, 27], sentinel C
    live = torch.cat([mn.sum(dim=1), mn.new_zeros((1,), dtype=torch.long)])
    return int((mc.sum(dim=1) * live[nbr].sum(dim=1)).sum())


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
    planes = PLANES_READ.get(family, 8)  # f32 planes per tier
    tiers = 1 if nbr_tier is cen else 2  # a self pass reads its tier once
    n_bytes = (4 * planes * needed_slots(cen[4], nbr_tier[4], grid)
               + c * k * (tiers + 4 * n_out_planes))
    flop = FLOP_PER_PAIR[family] * count_pairs(cen, nbr_tier, grid, params, kernel)
    if family in FLOP_PER_CANDIDATE:
        flop += FLOP_PER_CANDIDATE[family] * count_candidates(cen, nbr_tier,
                                                              grid)
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_flop else "operations"
    return 1e3 * max(t_bytes, t_flop), by, n_bytes, flop


def widened(tier, k, params):
    """Tier ``(x, v, rho, p, mask)`` with its slots padded to ``k`` by
    dead ones (zero fields, ``rho0``, mask off), as the step fills them."""
    def pad(t, fill):
        extra = t.new_full(t.shape[:-1] + (k - t.shape[-1],), fill)
        return torch.cat([t, extra], dim=-1).contiguous()

    x, v, rho, p, m = tier
    return (pad(x, 0.0), pad(v, 0.0), pad(rho, params.rho0), pad(p, 0.0),
            pad(m, False))


def pair_passes(a, b, grid, params, options=True):
    """``family -> (output planes, kernel(cen, nbr, role, tile=None),
    plain(cen, nbr))`` for tiers ``(x, v, rho, p, mask)``; the kernels are
    launched as the two-tier entry points launch them, on tiers whose
    pressure plane is folded beforehand (``tile`` forces the cells per CTA
    of the tile kernels).  ``options`` adds the option passes' families;
    the force passes take each tier's complete normals (computed here by
    the normals kernel)."""
    folded = {id(t): t[:3] + (ops.pressure_plane(t[2], t[3], params),) + t[4:]
              for t in (a, b)}

    def accel(delta_sph, extra=None):
        return lambda c, n, role, tile=None: ops._launch_accel(
            *folded[id(c)], *folded[id(n)], grid, params, WendlandC2, role,
            delta_sph, tile, extra)

    passes = {
        "density": (
            1,
            lambda c, n, role, tile=None: ops._launch_density(
                c[0], c[4], n[0], n[4], grid, params, WendlandC2, role, tile),
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
    if not options:
        return passes
    normals = complete_normals(a, b, grid, params)
    gamma = OPTIONS["surface_tension"]
    passes.update({
        "accel_xsph": (
            6, accel(None, "xsph"),
            lambda c, n: ops.accel_pairs_plain(*c, *n, grid, params,
                                               xsph=True)),
        "accel_drho_xsph": (
            7, accel(DELTA_SPH, "xsph"),
            lambda c, n: ops.accel_drho_pairs_plain(
                *c, *n, grid, params, delta_sph=DELTA_SPH, xsph=True)),
        "st_normals": (
            3,
            lambda c, n, role, tile=None: ops._launch_st_normals(
                c[0], c[4], n[0], n[2], n[4], grid, params, WendlandC2,
                role, tile),
            lambda c, n: ops.st_normals_pairs_plain(
                c[0], c[4], n[0], n[2], n[4], grid, params)),
        "st_force": (
            3,
            lambda c, n, role, tile=None: ops._launch_st_force(
                c[0], normals[id(c)], c[2], c[4], n[0], normals[id(n)], n[2],
                n[4], grid, params, WendlandC2, gamma, role, tile),
            lambda c, n: ops.st_force_pairs_plain(
                c[0], normals[id(c)], c[2], c[4], n[0], normals[id(n)], n[2],
                n[4], grid, params, gamma)),
        "energy": (
            1, accel(None, "energy"),
            lambda c, n: ops.energy_pairs_plain(*c, *n, grid, params)),
    })
    return passes


def tile_note(family, grid, params):
    """``T=.., dynamic shared memory .. B``: the tile a tile launch of
    ``family`` runs on ``grid`` and the shared memory it asks for."""
    return "T=%d, dynamic shared memory %d B" % (
        ops.tile_cells(grid, params),
        ops.tile_shared_bytes(family, grid, params))


def step_ms(step, state, reps, warmup, dt0=None):
    """Mean device milliseconds of one step over ``reps`` steps (of an
    adaptive step from ``dt0``, carrying the controller's dt)."""
    box = [state, None if dt0 is None else device_dt(dt0, state)]

    def run():
        box[0], _, box[1] = advance(step, box[0], box[1])

    return cuda_ms(run, reps, warmup)


def ghost_halo_ms(grid, dev, tiers, continuity):
    """Device milliseconds a periodic step spends on its ghost halo: the
    gathers of every plane into the ghost tiers and of the outputs back to
    the interior rows, replayed on tensors of the step's shapes (``tiers``
    is 2 on the spill layout, 1 on the single tier)."""
    wrap = tuple(bool(d >= 3) for d in grid.dims)
    g, src, shift, interior = ops._ghost_index(grid, wrap, dev)
    c, k = grid.n_cells, grid.capacity
    x = torch.zeros((3, c, k), device=dev)
    f = torch.zeros((c, k), device=dev)
    m = torch.zeros((c, k), dtype=torch.bool, device=dev)
    out = torch.zeros((4, g.n_cells, k), device=dev)

    def run():
        for _ in range(tiers):
            if not continuity:  # the density pass
                ops._ghost_tier((x, m), src, shift)
                out[0].index_select(-2, interior)
            ops._ghost_tier((x, x, f, f, m), src, shift)
            out[: 4 if continuity else 3].index_select(-2, interior)

    return cuda_ms(run, 10, 2)


def phase_times(dev, card, params, steps100, inputs24, inputs32, wide):
    """Phase 6: step and kernel times on the card (CUDA events), and each
    kernel role's roofline bound on the same inputs (the flagship's K =
    32 and, with the spill tier occupied, K = 24; the wide roles on the
    single tier at K = 128, ``wide`` = its tier and plain passes' times).
    The 1M steps with the options on are timed beside the same steps
    without them."""
    base_ms = {}
    for mode, (step_k100, step_p100, state100) in steps100.items():
        n100 = state100.x.shape[0]
        k100 = step_ms(step_k100, state100, 20, 3)
        p100 = step_ms(step_p100, state100, 3, 1)
        print("phase 6 (%s): N=%d kernel path %.4f ms/step (%.4g "
              "particle-steps/s), plain path %.4f ms/step (%.4g "
              "particle-steps/s) [%s]" % (mode, n100, k100, n100 / k100 * 1e3,
                                          p100, n100 / p100 * 1e3, card))

        step_k1m, state1m = configuration("spill", N_1M, dev, mode)
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
        base_ms[("spill", mode)] = k1m
        del step_k1m, state1m

    # each kernel role at the main paths' shapes (K = 32, centres in the
    # main tier; the spill tier is empty there): these are the rows of the
    # ``kernels`` line
    grid, a, b = inputs32["grid"], inputs32["a"], inputs32["b"]
    times = {}
    for family, (n_out, kern, plain) in pair_passes(a, b, grid, params).items():
        option = family in OPTION_FAMILIES
        for role, nbr_tier in (("self", a), ("cross", b)):
            kms = cuda_ms(lambda: kern(a, nbr_tier, role), 20, 3)
            # an option pass's plain version runs twice (seconds each)
            pms = cuda_ms(lambda: plain(a, nbr_tier), *((1, 1) if option
                                                          else (3, 1)))
            bound_ms, by, n_bytes, flop = roofline(
                family, a, nbr_tier, grid, params, WendlandC2, n_out)
            key = "%s_%s" % (family, role)
            times[key] = {"ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                          "bound_by": by}
            print("phase 6: %s at N=%d, K=%d (centres A; %s): kernel %.4f "
                  "ms, plain %.4f ms, bound %.4f ms by %s (%.4g bytes, %.4g "
                  "flop; kernel at %.1f%% of the bound's rate)%s [%s]"
                  % (key, N_1M_PARTICLES, grid.capacity,
                     tile_note(family, grid, params), kms, pms, bound_ms, by,
                     n_bytes, flop, 100.0 * bound_ms / kms,
                     launches_note(key), card))

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
                  "%d live neighbours; %s): kernel %.4f ms, bound %.4f ms by "
                  "%s (%.4g bytes, %.4g flop; kernel at %.1f%% of the "
                  "bound's rate) [%s]"
                  % (family, role, N_1M_PARTICLES, grid.capacity,
                     names[id(cen)], names[id(nbr_tier)], int(cen[4].sum()),
                     int(nbr_tier[4].sum()), tile_note(family, grid, params),
                     kms, bound_ms, by, n_bytes, flop,
                     100.0 * bound_ms / kms, card))

    # the wide roles at the wide main paths' shapes (the single tier at
    # K = 128): the wide rows of the ``kernels`` line.  An option pass's
    # plain version runs once here, and the kernel is held against it.
    grid_w, params_w, tier = wide["tier"]
    passes_w = pair_passes(tier, tier, grid_w, params_w)
    for family, (n_out, kern, plain) in passes_w.items():
        key = family + "_wide"
        kms = cuda_ms(lambda: kern(tier, tier, "self"), 20, 3)
        if family in OPTION_FAMILIES:
            want, pms = timed(lambda: plain(tier, tier))
            got = kern(tier, tier, "self")
            hold_planes({"abs": 0.0, "scaled": 0.0, "planes": {}},
                        "%s N=%d K=%d" % (key, N_1M_PARTICLES, K_WIDE), got,
                        want, tier[4], 1e-4, 1e-5, OPTION_GROUPS[family])
            del want, got
        else:
            pms = wide["plain_ms"][key]
        bound_ms, by, n_bytes, flop = roofline(
            family, tier, tier, grid_w, params_w, WendlandC2, n_out)
        times[key] = {"ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                      "bound_by": by}
        print("phase 6: %s at N=%d, K=%d (single tier; %s): kernel %.4f ms, "
              "plain %.4f ms, bound %.4f ms by %s (%.4g bytes, %.4g flop; "
              "kernel at %.1f%% of the bound's rate; %.2f times the K=32 self "
              "role)%s [%s]"
              % (key, N_1M_PARTICLES, grid_w.capacity,
                 tile_note(family, grid_w, params_w), kms, pms, bound_ms, by,
                 n_bytes, flop, 100.0 * bound_ms / kms,
                 kms / times[family + "_self"]["ms"], launches_note(key),
                 card))
    del passes_w

    # the tile kernels past 64 slots: the same particles in the first 32
    # of K_WIDE slots (the spill tier is empty at K = 32, so the K = 32
    # tier holds every particle), held to the K = 32 launch
    grid, a = inputs32["grid"], inputs32["a"]
    passes = pair_passes(a, a, grid, params, options=False)
    wide_a = widened(a, K_WIDE, params)
    grid_k = grid._replace(capacity=K_WIDE)
    passes_k = pair_passes(wide_a, wide_a, grid_k, params, options=False)
    for family, rtol, atol in (("density", 1e-5, 1e-6),
                               ("accel", 1e-4, 1e-5),
                               ("accel_drho", 1e-4, 1e-5)):
        got = passes_k[family][1](wide_a, wide_a, "self")
        want = passes[family][1](a, a, "self")
        if bool(got[..., 32:].any()):
            raise AssertionError("%s at K=%d: nonzero dead slot" % (family,
                                                                   K_WIDE))
        hold_planes({"abs": 0.0, "scaled": 0.0, "planes": {}},
                    "%s K=%d slots [:32] against K=32" % (family, K_WIDE),
                    got[..., :32].contiguous(), want, a[4], rtol, atol)
        kms = cuda_ms(lambda: passes_k[family][1](wide_a, wide_a, "self"),
                      20, 3)
        print("phase 6: %s_wide on the K=32 self-role particles in %d slots "
              "(%s): %.4f ms against %.4f ms of %s_self at K=32 (%.3f times; "
              "largest difference %.3g) [%s]"
              % (family, K_WIDE, tile_note(family, grid_k, params), kms,
                 times[family + "_self"]["ms"], family,
                 kms / times[family + "_self"]["ms"],
                 float((got[..., :32] - want).abs().max()), card))
    del wide_a

    # the wide and the periodic steps
    for mode in PATHS_MODES:
        for n_side in (N_100K, N_1M):
            step, state = configuration("wide", n_side, dev, mode)
            n = state.x.shape[0]
            kms = step_ms(step, state, 20, 3)
            msg = ("phase 6 (wide %s): N=%d, K=%d kernel path %.4f ms/step "
                   "(%.4g particle-steps/s)" % (mode, n, K_WIDE, kms,
                                                n / kms * 1e3))
            if n_side == N_100K:
                step_p, _ = configuration("wide", n_side, dev, mode, plain=True)
                _, pms = timed(lambda: step_p(state))
                msg += ", plain path %.1f ms/step (one step)" % pms
            else:
                base_ms[("wide", mode)] = kms
            print(msg + " [%s]" % card)
            del step, state
    for layout, mode in (("periodic spill", "summation"),
                         ("periodic spill", "continuity"),
                         ("periodic wide", "summation")):
        step, state = configuration(layout, N_BOX_1M, dev, mode)
        n = state.x.shape[0]
        kms = step_ms(step, state, 10, 3)
        sc_grid = still_box(
            n_side=N_BOX_1M, capacity=K_WIDE if layout.endswith("wide")
            else "auto", device="cpu").grid
        if not layout.endswith("wide"):
            sc_grid = sc_grid._replace(
                capacity=min(max(sc_grid.capacity, 24), 64))
        tiers = 1 if layout.endswith("wide") else 2
        gms = ghost_halo_ms(sc_grid, dev, tiers, mode == "continuity")
        print("phase 6 (%s %s): N=%d, grid %s, K=%d: %.4f ms/step (%.4g "
              "particle-steps/s), of which the ghost halo's gathers %.4f ms "
              "(%.1f%%) [%s]"
              % (layout, mode, n, "x".join(map(str, sc_grid.dims)),
                 sc_grid.capacity, kms, n / kms * 1e3, gms, 100.0 * gms / kms,
                 card))
        del step, state
    for (layout, mode), base in base_ms.items():
        step, state = configuration(layout, N_1M, dev, mode, options=OPTIONS)
        n = state.x.shape[0]
        kms = step_ms(step, state, 20, 3)
        print("phase 6 (%s %s with %s): N=%d kernel path %.4f ms/step (%.4g "
              "particle-steps/s), %.4f ms/step more than without the options "
              "(%.4f) [%s]"
              % (layout, mode, json.dumps(OPTIONS), n, kms, n / kms * 1e3,
                 kms - base, base, card))
        del step, state
    return times


def launches_note(key):
    """``; N launches a step on the <path> path`` of a role."""
    for _, k, _, path in KERNELS:
        if k == key and path in PATHS:
            return "; %d launches a step on the %s path" % (
                PATHS[path]["per_step"].get(key, 0), path)
    return ""


#: layer groups of the profile, by a fragment of the device kernel's name
#: (first match wins; the rest is elementwise: EOS, integrate, masks)
PROFILE_GROUPS = [
    ("pair kernels",
     ("_pairs_kernel", "st_normals_kernel", "st_force_kernel")),
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


def phase_profile(dev, card, layout, n_side, density_mode, steps=10,
                  warmup=5, options=None, dt0=None, tag="phase 7"):
    """Phase 7: one torch.profiler trace of ``steps`` steps of a
    ``configuration`` (``options`` as there; with ``dt0`` its adaptive
    step, carrying the controller's dt from ``dt0``), read by
    :func:`profile_run`."""
    step, state = configuration(layout, n_side, dev, density_mode,
                                options=options, adaptive=dt0 is not None)
    box = [state, None if dt0 is None else device_dt(dt0, state)]

    def run():
        box[0], _aux, box[1] = advance(step, box[0], box[1])

    label = "%s%s %s%s" % ("adaptive " if dt0 is not None else "", layout,
                           density_mode,
                           " with %s" % json.dumps(options) if options else "")
    profile_run(run, state.x.shape[0], steps, warmup, tag, label, card)


def profile_run(run, n, steps, warmup, tag, label, card):
    """One torch.profiler trace of ``steps`` calls of ``run`` (one step
    each) after ``warmup`` calls.  The device busy time (union of the
    device activity) and the wall time both come from that trace: wall
    is the span of a host region that ends with a device sync.  The
    profiler slows the host side, so the idle share is that of the
    profiled run.  Prints the device time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("tpgsd_torch.profiled_steps"):
            for _ in range(steps):
                run()
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
    print("%s (%s): N=%d profiled %d steps: wall %.4f ms/step, device "
          "busy %.4f ms/step, idle share %.4f (%d device events outside "
          "the region) [%s]"
          % (tag, label, n, steps, wall / steps / 1e3, busy / steps / 1e3,
             1.0 - busy / wall, outside, card))
    groups, other = {}, {}
    for e in device:
        g = next((name for name, keys in PROFILE_GROUPS
                  if any(k in e.name for k in keys)), "elementwise/other")
        us, count = groups.get(g, (0.0, 0))
        groups[g] = (us + e.time_range.elapsed_us(), count + 1)
        if g == "elementwise/other":
            us, count = other.get(e.name, (0.0, 0))
            other[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    total = sum(us for us, _ in groups.values())
    for g, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print("  %-26s %.4f ms/step (%.1f%% of device time), %.1f "
              "launches/step" % (g, us / steps / 1e3, 100.0 * us / total,
                                 count / steps))
    # the largest kernels of the catch-all group, by name
    for name, (us, count) in sorted(other.items(), key=lambda kv: -kv[1][0])[:4]:
        print("    elementwise/other: %.4f ms/step, %.1f launches/step: %s"
              % (us / steps / 1e3, count / steps, name[:150]))


def device_dt(dt0, state):
    """``dt0`` as the 0-d float32 tensor on the state's device that an
    adaptive step takes."""
    return initial_dt(dt0, state.x.device)[0]


def phase_adaptive_vs_fixed(dev, card, params):
    """Phase 8: the adaptive step at ``dt == params.dt`` against the fixed
    step at 1M, on both layouts in both modes: 3 steps each, bit-identical
    positions, velocities and density, the same launch counts; then both
    timed (CUDA events) and the adaptive step profiled as phase 7 profiles
    the fixed one."""
    for layout in ("spill", "wide"):
        for mode in PATHS_MODES:
            tag = "phase 8 (%s %s)" % (layout, mode)
            step_f, state = configuration(layout, N_1M, dev, mode)
            step_a, state_a = configuration(layout, N_1M, dev, mode,
                                            adaptive=True)
            if step_a.resolved != step_f.resolved or not all(
                    torch.equal(a, b) for a, b in zip(state, state_a)
                    if a is not None):
                raise AssertionError("%s: the adaptive configuration differs"
                                     % tag)
            del state_a
            dt = device_dt(params.dt, state)
            s_f, aux_f, counts_f = run_counted(step_f, state, 3)
            s_a, aux_a, counts_a = run_counted(step_a, state, 3, dt)
            path = ("wide " if layout == "wide" else "") + mode
            want = {k: 3 * v for k, v in PATHS[path]["per_step"].items()}
            if counts_f != want or counts_a != want:
                raise AssertionError("%s: launches fixed %s, adaptive %s, "
                                     "expected %s" % (tag, counts_f, counts_a,
                                                      want))
            for name, a, b in (("positions", s_a.x, s_f.x),
                               ("velocities", s_a.v, s_f.v),
                               ("density", aux_a[0], aux_f[0])):
                if not torch.equal(a, b):
                    raise AssertionError(
                        "%s: adaptive %s differ from the fixed step's at dt "
                        "== params.dt (max %g)"
                        % (tag, name, float((a - b).abs().max())))
            del s_f, s_a, aux_f, aux_a
            fixed_ms = step_ms(step_f, state, 20, 3)
            adaptive_ms = step_ms(step_a, state, 20, 3, dt0=params.dt)
            print("%s: N=%d, 3 steps at dt == params.dt bit-identical to the "
                  "fixed step, launches %s each; fixed %.4f ms/step, adaptive "
                  "%.4f ms/step (+%.4f; CUDA events over 20 steps) [%s]"
                  % (tag, state.x.shape[0], json.dumps(counts_a), fixed_ms,
                     adaptive_ms, adaptive_ms - fixed_ms, card))
            del step_f, step_a, state
            phase_profile(dev, card, layout, N_1M, mode, dt0=params.dt,
                          tag="phase 8")


def controller_bound(step_state, dt_next, params, cfl):
    """Which condition set ``dt_next``, recomputed on the device from the
    state the step returned: ``"ceiling"`` (params.dt), ``"Courant"`` (h /
    (c0 + max|v|)) or ``"force"`` (sqrt(h / max|a|)), as the controller
    of ``make_adaptive_step_fn`` computes them."""
    v2max = torch.amax(torch.sum(step_state.v * step_state.v, dim=-1))
    vmax = torch.sqrt(torch.clamp(v2max, min=1e-30))
    courant = torch.clamp(cfl * torch.div(params.h, params.c0 + vmax),
                          min=0.0, max=params.dt)
    if float(dt_next) == float(np.float32(params.dt)):
        return "ceiling"
    return "Courant" if torch.equal(courant, dt_next) else "force"


def phase_rollout(dev, card, params, mode, cfl=0.25):
    """Phase 8: a 200-step adaptive rollout of the 1M spill step in
    ``mode`` through ``run_adaptive`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), replayed
    step by step (the dts, the states every 10th step); the same rollout
    through ``scan_simulate_adaptive`` with a frame every 10th step into
    the port's writer, read back against the replay; in continuity mode a
    ``resume`` from that file, 10 more steps appended, held against 10
    steps of the in-memory state."""
    tag = "phase 8 (spill %s rollout)" % mode
    step, state0 = configuration("spill", N_1M, dev, mode, adaptive=True)
    n = state0.x.shape[0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_run, dt_run, t_run = run_adaptive(step, state0, params.dt, N_ROLLOUT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts.items() if v}
    want = {k: N_ROLLOUT * v for k, v in PATHS[mode]["per_step"].items()}
    if counts != want:
        raise AssertionError("%s: launches %s, expected %s"
                             % (tag, counts, want))

    # the replay: each dt taken, the states the dump will hold
    dts, kept, overflow = [], {}, []
    s, dt = state0, device_dt(params.dt, state0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(N_ROLLOUT):
            dts.append(dt)
            s, aux, dt = step(s, dt)
            overflow.append(aux[2])
            if i % DUMP_EVERY == 0:
                kept[i] = (s, aux[0])
            if i == N_ROLLOUT - DUMP_EVERY:
                dt_resume = dt  # the dt of step i + 1, kept on the device
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dts = torch.stack(dts).cpu().numpy()
    if int(torch.stack(overflow).sum()):
        raise AssertionError("%s: overflow" % tag)
    if not (torch.equal(s.x, s_run.x) and torch.equal(s.v, s_run.v)
            and torch.equal(dt, dt_run)):
        raise AssertionError("%s: run_adaptive differs from its replay" % tag)
    dt_cap = np.float32(params.dt)
    if not ((dts > 0).all() and (dts <= dt_cap).all()):
        raise AssertionError("%s: a dt outside (0, params.dt]: %s"
                             % (tag, dts[(dts <= 0) | (dts > dt_cap)][:4]))
    t_host = np.float32(0.0)
    for d in dts:
        t_host = np.float32(t_host + d)
    if t_run.cpu().numpy() != t_host:
        raise AssertionError("%s: t %r is not the float32 sum of the dts %r"
                             % (tag, float(t_run), float(t_host)))
    if not all(bool(torch.isfinite(a).all()) for a in s_run if a is not None):
        raise AssertionError("%s: the state is not finite" % tag)
    ratio = dts / dt_cap
    speed = torch.linalg.vector_norm(s_run.v, dim=1)
    print("%s: N=%d, %d steps through run_adaptive with no host sync "
          "(sync debug mode \"error\") in %.3f s (%.4f ms/step, host clock), "
          "launches %s, overflow 0, state finite; dt/params.dt min %.4f, "
          "median %.4f, max %.4f; t = %.6f s, the float32 sum of the dts "
          "bit for bit; at the end the %s condition bound, |v| max %.4g, "
          "99.9th percentile %.4g, median %.4g m/s (c0 %.4g) [%s]"
          % (tag, n, N_ROLLOUT, wall, 1e3 * wall / N_ROLLOUT,
             json.dumps(counts), ratio.min(), np.median(ratio), ratio.max(),
             float(t_run), controller_bound(s_run, dt_run, params, cfl),
             float(speed.max()), float(torch.quantile(speed, 0.999)),
             float(speed.median()), params.c0, card))
    del s, speed

    names = ["particles/position", "particles/velocity", "particles/density"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rollout.gsd")
        writer = ShardedFrameWriter(
            path, application="tpgsd_torch.chip_smoke", comm=SingleComm(),
            static={"configuration/box": np.array(
                [2.0, 1.0, 1.0, 0.0, 0.0, 0.0], np.float32)},
        )
        channel = JitDumpChannel(writer, names)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        s_d, dt_d, t_d = scan_simulate_adaptive(
            step, state0, params.dt, N_ROLLOUT, channel,
            lambda st, aux: [st.x, st.v, aux[0]], every=DUMP_EVERY,
        )
        channel.close()
        wall = time.perf_counter() - t0
        dump_counts = {k: v for k, v in ops.launch_counts.items() if v}
        if dump_counts != want:
            raise AssertionError("%s: launches with the dump %s" % (tag,
                                                                    dump_counts))
        if not (torch.equal(s_d.x, s_run.x) and torch.equal(s_d.v, s_run.v)
                and torch.equal(dt_d, dt_run) and torch.equal(t_d, t_run)):
            raise AssertionError("%s: scan_simulate_adaptive's state, dt or "
                                 "t differ from run_adaptive's" % tag)
        del s_d, s_run
        stats = channel.stats
        print("%s: scan_simulate_adaptive, %d steps with a frame every %dth "
              "(%d frames of %d chunks) in %.3f s (%.4f ms/step incl. dump), "
              "dump %.1f MB/s while writing [%s]"
              % (tag, N_ROLLOUT, DUMP_EVERY, stats.frames, len(names), wall,
                 1e3 * wall / N_ROLLOUT, stats.write_mb_s, card))
        frame_steps = list(range(0, N_ROLLOUT, DUMP_EVERY))
        with tpgsd_torch.hoomd.open(path, mode="r") as traj:
            steps = [int(f.configuration.step) for f in traj]
            if steps != frame_steps:
                raise AssertionError("%s: frame steps %s" % (tag, steps))
            for frame, i in zip(traj, frame_steps):
                (st, rho) = kept[i]
                for got, want_t in ((frame.particles.position, st.x),
                                    (frame.particles.velocity, st.v),
                                    (frame.particles.density, rho)):
                    if not np.array_equal(got, want_t.cpu().numpy()):
                        raise AssertionError(
                            "%s: frame of step %d differs from the state "
                            "after %d steps without a dump" % (tag, i, i + 1))
        print("%s: file read back: %d frames, steps 0, %d, ..., %d; frame i "
              "bit-equal to the state after i + 1 steps of the rollout "
              "without a dump" % (tag, len(frame_steps), DUMP_EVERY,
                                  frame_steps[-1]))
        if mode == "continuity":
            resume_phase(tag, step, path, kept[frame_steps[-1]][0],
                         frame_steps[-1], dt_resume, card)


def resume_phase(tag, step, path, state_last, last_step, dt_resume, card):
    """Resume the continuity rollout's file onto the card, run 10 adaptive
    steps from the dt the rollout kept, a frame appended each step, and
    hold them against 10 steps of the in-memory state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, step_no, writer, _ = resume(path, comm=SingleComm(),
                                       device=state_last.x.device,
                                       density_mode="continuity")
    torch.cuda.synchronize()
    resume_ms = 1e3 * (time.perf_counter() - t0)
    if step_no != last_step:
        raise AssertionError("%s: resumed at step %d" % (tag, step_no))
    for a, b in zip(state, state_last):
        if not torch.equal(a, b):
            raise AssertionError("%s: the resumed state differs from the "
                                 "last frame's" % tag)
    s, dt = state, dt_resume
    with writer:
        for j in range(N_RESUMED):
            s, _aux, dt = step(s, dt)
            writer.write_frame({"particles/position": s.x,
                                "particles/velocity": s.v,
                                "particles/density": s.rho},
                               step=last_step + 1 + j)
    s_mem, dt_mem, _t = run_adaptive(step, state_last, dt_resume, N_RESUMED)
    for name, a, b in (("positions", s.x, s_mem.x),
                       ("velocities", s.v, s_mem.v)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError("%s: resumed %s off by %g" % (
                tag, name, float((a - b).abs().max())))
    identical = (torch.equal(s.x, s_mem.x) and torch.equal(s.v, s_mem.v)
                 and torch.equal(s.rho, s_mem.rho) and torch.equal(dt, dt_mem))
    want_steps = (list(range(0, last_step + 1, DUMP_EVERY))
                  + list(range(last_step + 1, last_step + 1 + N_RESUMED)))
    with tpgsd_torch.hoomd.open(path, mode="r") as traj:
        steps = [int(f.configuration.step) for f in traj]
        last = traj[-1].particles.position
    if steps != want_steps or not np.array_equal(last, s.x.cpu().numpy()):
        raise AssertionError("%s: after resume the file holds steps %s"
                             % (tag, steps))
    print("%s: resume of the frame of step %d (N=%d) onto the card in %.3f "
          "ms (file read included), state bit-equal to the frame; %d "
          "adaptive steps from the kept dt appended (file: %d frames, steps "
          "in order), within rtol 1e-5, atol 1e-6 of %d steps of the "
          "in-memory state, %s [%s]"
          % (tag, last_step, s.x.shape[0], resume_ms, N_RESUMED,
             len(want_steps), N_RESUMED,
             "bit-identical" if identical else "not bit-identical", card))


def phase_lattice(dev, card):
    """Phase 8: the 1M dam break's lattice built on the card against the
    host lattice: the same count, grid and capacity, positions within
    1e-6; both build times (host clock, device synchronised), twice."""
    times = {False: [], True: []}
    for on_device in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                       device=dev, on_device=on_device)
        torch.cuda.synchronize()
        times[on_device].append(1e3 * (time.perf_counter() - t0))
        if not on_device:
            host = db
            continue
        if (db.n, db.grid, db.params) != (host.n, host.grid, host.params):
            raise AssertionError("on-device lattice: n %d grid %s, host n %d "
                                 "grid %s" % (db.n, db.grid, host.n, host.grid))
        if not (torch.allclose(db.state.x, host.state.x, rtol=0, atol=1e-6)
                and not db.state.v.any()):
            raise AssertionError("on-device lattice positions differ")
    print("phase 8 (lattice): dam_break(n_side=%d, capacity=\"auto\", "
          "capacity_headroom=1.15): N=%d, grid %s, K=%d on the card and on "
          "the host, positions within 1e-6; host lattice %s ms, on-device "
          "%s ms (two calls each) [%s]"
          % (N_1M, db.n, "x".join(map(str, db.grid.dims)), db.grid.capacity,
             " / ".join("%.3f" % t for t in times[False]),
             " / ".join("%.3f" % t for t in times[True]), card))


def slab_dam_break(config, dev, on_device=False):
    """The dam break of a phase 9 configuration, its size and grid
    checked."""
    n_side, n, dims, _ = config
    db = dam_break(n_side=n_side, capacity="auto", capacity_headroom=1.15,
                   device=dev, on_device=on_device)
    if (db.n, tuple(db.grid.dims), db.grid.capacity) != (n, dims, 32):
        raise AssertionError("dam_break(n_side=%d): N=%d, grid %s, K=%d"
                             % (n_side, db.n, db.grid.dims, db.grid.capacity))
    return db


def slab_launches(layout, mode, n_slabs, n_steps):
    """Kernel launches of ``n_steps`` slab steps: a slab launches what a
    step of the global step on the same layout does."""
    path = ("wide " if layout == "wide" else "") + mode
    return {k: v * n_slabs * n_steps
            for k, v in PATHS[path]["per_step"].items()}


def slab_state(db, grid, dev, density_mode, slabs=None):
    """Phase 3's jittered state with N(0, 1) velocities of ``db``; in
    continuity mode seeded with the summation density (the slab seed with
    ``slabs``, else the global one)."""
    x, v = jittered(db, dev)
    state = db.state._replace(x=x, v=v)
    if density_mode == "continuity":
        if slabs:
            state = slab_init_density(state, grid, db.params, slabs,
                                      device=dev)
        else:
            state = init_density(state, grid, db.params, device=dev)
    return state


def phase_slab_kernels_vs_plain(dev, card):
    """Phase 9: one slab kernel step against one slab plain step on the
    100k dam break (4 slabs of 10 core planes, each slab's extended grid
    with the two empty virtual planes at the domain's ends), in both
    modes, on the spill layout at K = 32 and K = 24 (the spill tier
    occupied) and on the single tier at K = 128: every one of the nine
    kernel roles on the slab path.  Positions rtol 1e-5, atol 1e-6;
    density rtol 1e-5; velocities at tests/test_bigstep.py's tolerances
    of the slab step against the global step (:data:`SLAB_TOLERANCES`)."""
    db = slab_dam_break(SLAB_100K, dev)
    slabs = SLAB_100K[3]
    for k in (32, 24, K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            tag = "phase 9 (slab %s K=%d %s)" % (layout, k, mode)
            state = slab_state(db, grid, dev, mode, slabs)
            step_k = make_slab_step_fn(grid, db.params, slabs,
                                       density_mode=mode, device=dev)
            step_p = make_slab_step_fn(grid, db.params, slabs,
                                       density_mode=mode, device=dev,
                                       use_kernels=False,
                                       spill=layout == "spill")
            want = {"use_kernels": True, "spill": layout == "spill",
                    "density_mode": mode}
            if step_k.resolved != want:
                raise AssertionError("%s resolved to %r"
                                     % (tag, step_k.resolved))
            sk, (rk, _pk, ok, wk), counts = run_counted(step_k, state, 1)
            sp, (rp, _pp, op, wp) = step_p(state)
            if counts != slab_launches(layout, mode, slabs, 1):
                raise AssertionError("%s: launches %s" % (tag, counts))
            if int(ok) != int(op) or int(wk) or int(wp):
                raise AssertionError("%s: cell overflow %d / %d, window %d "
                                     "/ %d" % (tag, int(ok), int(op),
                                               int(wk), int(wp)))
            torch.testing.assert_close(sk.x, sp.x, rtol=1e-5, atol=1e-6)
            v_rtol, v_atol = SLAB_TOLERANCES[mode][2]
            torch.testing.assert_close(sk.v, sp.v, rtol=v_rtol, atol=v_atol)
            torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0.0)
            n_spill = 0
            if layout == "spill":
                cnt = torch.bincount(cell_id(state.x, grid),
                                     minlength=grid.n_cells)
                n_spill = int(torch.clamp(cnt - k, min=0).sum())
            print("%s: N=%d, %d slabs, %d in the spill tier, cell overflow "
                  "%d; slab kernel step vs slab plain step: positions max "
                  "abs err %.3g (rtol 1e-5, atol 1e-6), velocities %.3g "
                  "(rtol %g, atol %g), density %.3g (rtol 1e-5); launches %s"
                  % (tag, db.n, slabs, n_spill, int(ok),
                     float((sk.x - sp.x).abs().max()),
                     float((sk.v - sp.v).abs().max()), v_rtol, v_atol,
                     float((rk - rp).abs().max()), json.dumps(counts)))


#: tests/test_bigstep.py's tolerances of the slab step against the global
#: step: (rho rtol, atol), (x rtol, atol), (v rtol, atol)
SLAB_TOLERANCES = {
    "summation": ((2e-5, 1e-2), (1e-5, 1e-7), (2e-4, 2e-4)),
    "continuity": ((5e-4, 0.0), (1e-5, 1e-6), (5e-4, 5e-4)),
}


def phase_slab_vs_global(dev, card):
    """Phase 9: the slab kernel step (12 slabs of 7 core planes) against
    the port's global kernel step on the 1M dam break from phase 3's
    jittered state, 3 steps, both modes, spill (K = 32) and single tier
    (K = 128), at tests/test_bigstep.py's tolerances, window overflow 0,
    the same cell overflow; whether the two are bit-identical.  Then 20
    silent slab steps under ``set_sync_debug_mode("error")``, and both
    steps timed (CUDA events)."""
    db = slab_dam_break(SLAB_1M, dev)
    slabs = SLAB_1M[3]
    for k in (32, K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            tag = "phase 9 (1M slab vs global, %s K=%d %s)" % (layout, k, mode)
            state = slab_state(db, grid, dev, mode)
            step_g = make_step_fn(grid, db.params, density_mode=mode,
                                  device=dev)
            step_s = make_slab_step_fn(grid, db.params, slabs,
                                       density_mode=mode, device=dev)
            if step_g.resolved != step_s.resolved:
                raise AssertionError("%s: resolved %r and %r" % (
                    tag, step_g.resolved, step_s.resolved))
            sg, ss = state, state
            for _ in range(3):
                sg, (rg, _pg, og) = step_g(sg)
                ss, (rs, _ps, os_, ws) = step_s(ss)
                if int(ws) or int(os_) != int(og):
                    raise AssertionError("%s: window overflow %d, cell "
                                         "overflow %d / %d"
                                         % (tag, int(ws), int(os_), int(og)))
            (r_rtol, r_atol), (x_rtol, x_atol), (v_rtol, v_atol) = \
                SLAB_TOLERANCES[mode]
            torch.testing.assert_close(rs, rg, rtol=r_rtol, atol=r_atol)
            torch.testing.assert_close(ss.x, sg.x, rtol=x_rtol, atol=x_atol)
            torch.testing.assert_close(ss.v, sg.v, rtol=v_rtol, atol=v_atol)
            same = (torch.equal(ss.x, sg.x) and torch.equal(ss.v, sg.v)
                    and torch.equal(rs, rg))
            ms_g = step_ms(step_g, state, 5, 1)
            ms_s = step_ms(step_s, state, 5, 1)
            print("%s: N=%d, 3 steps within tests/test_bigstep.py's "
                  "tolerances (max abs x %.3g, v %.3g, rho %.3g), window "
                  "overflow 0, cell overflow %d in both: %s; global %.4f "
                  "ms/step, slab %.4f ms/step (CUDA events over 5 steps) "
                  "[%s]" % (tag, db.n, float((ss.x - sg.x).abs().max()),
                            float((ss.v - sg.v).abs().max()),
                            float((rs - rg).abs().max()), int(og),
                            "bit-identical" if same else "not bit-identical",
                            ms_g, ms_s, card))
    step = make_slab_step_fn(db.grid, db.params, slabs, device=dev)
    state = slab_state(db, db.grid, dev, "summation")
    state, _ = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(20):
            state, aux = step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if int(aux[3]) or not bool(torch.isfinite(state.x).all()):
        raise AssertionError("phase 9: the silent slab steps overflowed or "
                             "are not finite")
    print("phase 9 (1M slab, no host sync): 20 silent slab steps (spill "
          "summation, %d slabs) under sync debug mode \"error\": 0 syncs, "
          "%.4f ms/step (host clock) [%s]" % (slabs, 1e3 * wall / 20, card))
    box = [state]

    def run():
        box[0], _aux = step(box[0])

    profile_run(run, db.n, 10, 2, "phase 9",
                "1M slab spill summation, %d slabs" % slabs, card)


def peak_bytes_per_particle(step, state, n_steps=1):
    """Peak device bytes a particle over ``n_steps`` steps from ``state``:
    ``max_memory_allocated`` (the state included) less what was allocated
    besides the state before, over N."""
    state_bytes = sum(t.numel() * t.element_size() for t in state
                      if t is not None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - state_bytes
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_steps):
        out, _aux = step(state)[:2]
        del out, _aux
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / state.x.shape[0]


def phase_global_peak(dev, card):
    """Phase 9: the global spill step's peak device bytes a particle at
    1M in both modes (and the slab step's beside it), and the N at which
    the global step would fill the card; the global step is not run at
    1e8.  Returns the projections by mode."""
    db = slab_dam_break(SLAB_1M, dev)
    total = torch.cuda.get_device_properties(0).total_memory
    projected = {}
    for mode in PATHS_MODES:
        state = slab_state(db, db.grid, dev, mode)
        step_g = make_step_fn(db.grid, db.params, density_mode=mode,
                              device=dev)
        step_s = make_slab_step_fn(db.grid, db.params, SLAB_1M[3],
                                   density_mode=mode, device=dev)
        step_g(state)  # warm-up: the kernels' constants, the caches
        g = peak_bytes_per_particle(step_g, state)
        s = peak_bytes_per_particle(step_s, state)
        projected[mode] = total / g
        print("phase 9 (peak memory, 1M spill %s): global step %.1f B a "
              "particle, slab step (%d slabs) %.1f B a particle "
              "(max_memory_allocated, the state included); the global "
              "step would fill the card's %.4g B at N = %.4g [%s]"
              % (mode, g, SLAB_1M[3], s, total, projected[mode], card))
        del state, step_g, step_s
    return projected


def hold_slab_roles(state, grid, params, n_slabs, card):
    """The three two-tier pair passes of the spill slab step (density,
    acceleration, acceleration + drho/dt) against their plain versions on
    three slabs' extended grids of ``state``, laid out by the slab step's
    own global pass (``bigstep.slab_tiers``), at phase 3's tolerances:
    the first slab (the domain's end, with its two empty virtual planes),
    the last slab that holds particles (the water column's front; the
    slabs past it are empty) and the one midway.  The densities and
    pressures the acceleration passes take are the plain density pass's,
    finished as the step finishes them.  The launches here are not
    counted as the main path's."""
    nxl = grid.dims[0] // n_slabs
    per_slab = torch.bincount(
        cell_id(state.x, grid) // (nxl * grid.dims[1] * grid.dims[2]),
        minlength=n_slabs)
    full = torch.nonzero(per_slab).flatten().tolist()
    chosen = sorted({full[0], full[len(full) // 2], full[-1]})
    print("phase 9 (1e8 slabs): %d of %d slabs hold particles; held: %s"
          % (len(full), n_slabs, chosen))
    for s, ext, tiers in slab_tiers(state, grid, n_slabs, chosen):
        (sa, ma), (sb, mb) = tiers
        tag = "phase 9 (1e8 slab %d of %d, %s cells, K=%d)" % (
            s, n_slabs, "x".join(map(str, ext.dims)), grid.capacity)
        errs = []
        t0 = time.perf_counter()
        got = ops.density_spill(sa[:3], ma, sb[:3], mb, ext, params)
        want = ops.density_spill_plain(sa[:3], ma, sb[:3], mb, ext, params)
        for t, live in enumerate((ma, mb)):
            if bool(live.any()):
                errs.append("density_spill tier %d %.6g" % (t, check_scaled(
                    "%s density_spill tier %d" % (tag, t), got[t], want[t],
                    live, 1e-5, 1e-6)))
        ra, pa = finish_density(want[0], ma, params)
        rb, pb = finish_density(want[1], mb, params)
        a = (sa[:3], sa[3:6], ra, pa, ma)
        b = (sb[:3], sb[3:6], rb, pb, mb)
        got = ops.accel_spill(*a, *b, ext, params)
        want = ops.accel_spill_plain(*a, *b, ext, params)
        for t, live in enumerate((ma, mb)):
            if bool(live.any()):
                errs.append("accel_spill tier %d %.6g" % (t, check_scaled(
                    "%s accel_spill tier %d" % (tag, t), got[t], want[t],
                    live, 1e-4, 1e-5)))
        got = ops.accel_drho_spill(*a, *b, ext, params, delta_sph=DELTA_SPH)
        want = ops.accel_drho_spill_plain(*a, *b, ext, params,
                                          delta_sph=DELTA_SPH)
        e_acc, e_drho, drho_max = check_drho_tiers(
            "%s accel_drho_spill" % tag, got, want, (ma, mb))
        torch.cuda.synchronize()
        print("%s: %d live slots in tier A, %d in tier B; kernel vs plain "
              "max abs err: %s, accel_drho_spill acc %.6g, drho %.6g "
              "(max|drho| %.6g); %.3f s [%s]"
              % (tag, int(ma.sum()), int(mb.sum()), ", ".join(errs), e_acc,
                 e_drho, drho_max, time.perf_counter() - t0, card))
        del sa, ma, sb, mb, a, b, got, want, ra, pa, rb, pb, tiers


def phase_cycle_1e8(dev, card):
    """Phase 9: the reference's 1e8-particle cycle
    (``benchmarks/benchmark_bigcycle.py --n-side 400 --slabs 32
    --spill``): the on-device dam break of 100,000,000 particles on 32
    slabs at K = 32; summation, 1 warm-up and 3 timed silent steps; a
    3-step cycle emitting one frame (position and velocity) through
    ``SlabDumpChannel`` into ``tempfile.gettempdir()``, closed, resumed,
    one more step, ``pypgsd.verify(deep=True)``, the frame bit-equal to
    the emitting step's output; continuity seeded by
    ``slab_init_density``, 1 warm-up and 3 timed steps.  Between the
    summation steps and the frame, the pair kernels are held against
    their plain versions on three slabs of the stepped state
    (:func:`hold_slab_roles`).  Returns the launch counts of the 4 silent
    steps of each mode."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    db = slab_dam_break(SLAB_1E8, dev, on_device=True)
    n, slabs, grid, params = db.n, SLAB_1E8[3], db.grid, db.params
    print("phase 9 (1e8 cycle): dam_break(n_side=%d, capacity=\"auto\", "
          "capacity_headroom=1.15, on_device=True): N=%d, grid %s = %d "
          "cells, K=%d, %d slabs of %d core planes (%d cells with the halo)"
          % (SLAB_1E8[0], n, "x".join(map(str, grid.dims)), grid.n_cells,
             grid.capacity, slabs, grid.dims[0] // slabs,
             (grid.dims[0] // slabs + 4) * grid.dims[1] * grid.dims[2]))
    counts = {}

    def timed_mode(mode, state):
        """1 warm-up and 3 timed silent steps (CUDA events) with the
        launch counts and the peak memory of all 4: the step, its
        ms/step and its last state."""
        step = make_slab_step_fn(grid, params, slabs, density_mode=mode,
                                 device=dev)
        if step.resolved != {"use_kernels": True, "spill": True,
                             "density_mode": mode}:
            raise AssertionError("1e8 %s resolved to %r" % (mode,
                                                            step.resolved))
        box, overflow = [state], []

        def run():
            box[0], aux = step(box[0])
            overflow.append(aux[2] + aux[3])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms = cuda_ms(run, 3, warmup=1)
        if int(torch.stack(overflow).sum()):
            raise AssertionError("1e8 %s: cell or window overflow" % mode)
        got = {k: v for k, v in ops.launch_counts.items() if v}
        if got != slab_launches("spill", mode, slabs, 4):
            raise AssertionError("1e8 %s: launches %s" % (mode, got))
        if ops.row_launch_counts["slot_rows"] != 4 * slabs:
            raise AssertionError("1e8 %s: slot_rows launched %d times"
                                 % (mode, ops.row_launch_counts["slot_rows"]))
        counts.update(got)
        counts["slot_rows"] = ops.row_launch_counts["slot_rows"]
        peak = (torch.cuda.max_memory_allocated() - base) / n
        print("phase 9 (1e8 %s): %.4f ms/step (CUDA events over 3 silent "
              "steps after 1), %.4g particle-steps/s, peak %.1f B a "
              "particle (%.4g GB, max_memory_allocated, the state "
              "included); launches of the 4 steps %s [%s]"
              % (mode, ms, n / (ms / 1e3), peak, peak * n / 1e9,
                 json.dumps(got), card))
        if not bool(torch.isfinite(box[0].x).all()):
            raise AssertionError("1e8 %s: positions not finite" % mode)
        return step, box[0], ms

    step, state, silent_ms = timed_mode("summation", db.state)
    del db
    box = [state]

    def run():
        box[0], _aux = step(box[0])

    profile_run(run, n, 2, 0, "phase 9",
                "1e8 slab spill summation, %d slabs" % slabs, card)
    state = box[0]
    del box
    hold_slab_roles(state, grid, params, slabs, card)
    torch.cuda.empty_cache()
    hold_slab_rows(step, state, grid, slabs, card)
    torch.cuda.empty_cache()

    tmpdir = tempfile.gettempdir()
    free = shutil.disk_usage(tmpdir).free
    frame_bytes = 2 * 3 * 4 * n
    print("phase 9 (1e8 frame): %.4g GB free in %s for one %.4g GB frame "
          "(position + velocity)" % (free / 1e9, tmpdir, frame_bytes / 1e9))
    if free < 1.5 * frame_bytes:
        raise AssertionError("not enough disk in %s for the frame" % tmpdir)
    path = os.path.join(tmpdir, "tpgsd_torch_chip_smoke_1e8.gsd")
    try:
        chan = SlabDumpChannel(
            ShardedFrameWriter(path, application="tpgsd_torch.chip_smoke",
                               comm=SingleComm()),
            n=n, n_slabs=slabs, keys=("position", "velocity"))
        step_e = make_slab_step_fn(grid, params, slabs,
                                   slab_emit=chan.slab_emit, device=dev)
        walls, emitted = [], None
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _aux = step_e(state, chan.dump(i) if i == 1
                                 else chan.no_dump())
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            if i == 1:
                emitted = state
                t0 = time.perf_counter()
                chan.flush()
                flush_ms = 1e3 * (time.perf_counter() - t0)
        chan.close()
        stats = chan.stats
        print("phase 9 (1e8 frame): a 3-step cycle, step 1 emitting: %.3f / "
              "%.3f / %.3f ms a step (host clock, device synchronised; the "
              "silent steps' CUDA-event mean above %.4f), the emission's "
              "host scatter done %.3f ms after its step (flush), %.3f s of "
              "scatters and %.3f s of frame hand-off to the writer on the "
              "emission thread; %.4g GB copied device-to-host "
              "(%d whole windows of %d rows), writer %.1f MB/s while "
              "writing [%s]"
              % (walls[0], walls[1], walls[2], silent_ms, flush_ms,
                 chan.emit_host_seconds, chan.handoff_seconds,
                 chan.d2h_bytes / 1e9, slabs,
                 -(-3 * n // slabs), stats.write_mb_s, card))
        del state
        t0 = time.perf_counter()
        resumed, step_no, writer, _ = resume(path, comm=SingleComm(),
                                             device=dev)
        writer.close()
        resume_s = time.perf_counter() - t0
        if step_no != 1 or not (torch.equal(resumed.x, emitted.x)
                                and torch.equal(resumed.v, emitted.v)):
            raise AssertionError("1e8: the frame (step %d) differs from the "
                                 "emitting step's output" % step_no)
        del emitted
        after, aux = step(resumed)
        torch.cuda.synchronize()
        if int(aux[3]) or not bool(torch.isfinite(after.x).all()):
            raise AssertionError("1e8: the step after the resume failed")
        del resumed, after, aux
        t0 = time.perf_counter()
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        fsck_s = time.perf_counter() - t0
        if not report["ok"] or report["frames"] != 1:
            raise AssertionError("1e8: fsck %s" % (report,))
        print("phase 9 (1e8 frame): resume in %.3f s, position and velocity "
              "bit-equal to the emitting step's output, one more step "
              "taken; pypgsd.verify(deep=True) ok in %.3f s (%d chunks, "
              "%d data bytes, file %d bytes) [%s]"
              % (resume_s, fsck_s, report["chunks"], report["data_bytes"],
                 report["file_size"], card))
    finally:
        if os.path.exists(path):
            os.remove(path)

    torch.cuda.empty_cache()
    db = slab_dam_break(SLAB_1E8, dev, on_device=True)
    t0 = time.perf_counter()
    seeded = slab_init_density(db.state, grid, params, slabs, device=dev)
    torch.cuda.synchronize()
    print("phase 9 (1e8 continuity): slab_init_density %.3f s (host clock, "
          "one summation slab step) [%s]" % (time.perf_counter() - t0, card))
    del db
    timed_mode("continuity", seeded)
    print("phase 9 (1e8 cycle) ran %.1f s" % (time.perf_counter() - t_start))
    return counts


# --------------------------------------------------------------------------
# phase 10: the slab domain decomposition (make_distributed_step_fn)
# --------------------------------------------------------------------------

#: shards of the 1M decomposition: two slabs of 41 planes, the reference
#: benchmark's fit at two devices (benchmarks/benchmark_sph.py:160-178)
DECOMP_SHARDS = 2
#: the 4-shard dam break: the long box of tests/test_distributed.py:26-36,
#: n_side chosen so that its 92 x cells divide by 4, the fluid along all
#: of x so that particles cross every slab face
DECOMP_4 = {"n_side": 15, "box": (4.0, 0.5, 0.5), "fill": (1.0, 1.0, 0.5)}
DECOMP_4_N, DECOMP_4_DIMS = 108000, (92, 11, 11)
DECOMP_4_V = 10.0  # the scale of its N(0, 1) velocities, m/s
#: the reference's decomposition tolerances against the global step
#: (tests/test_distributed.py:98-104)
DECOMP_X, DECOMP_V = dict(rtol=5e-4, atol=5e-5), dict(rtol=5e-3, atol=5e-3)
#: the 1M options run of the kernels line's option roles
DECOMP_OPTIONS = dict(OPTIONS, compute_energy=True)


def decomp_launches(path, n_shards):
    """Launches of one decomposed step: each shard launches what a step of
    the global step of ``path`` does."""
    return {k: v * n_shards for k, v in PATHS[path]["per_step"].items()}


def counted_step(step, state):
    """One step with the launch counts set to 0 just before: ``(state,
    aux, counts)``."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, aux = step(state)
    torch.cuda.synchronize()
    return state, aux, {k: v for k, v in ops.launch_counts.items() if v}


def dist_overflow(aux):
    """Total cell and migration overflow of a decomposed step's aux."""
    return (int(torch.stack([c.cpu() for c in aux.cell_overflow]).sum()),
            int(torch.stack([c.cpu() for c in aux.migrate_overflow]).sum()))


def check_complete(tag, dist, n):
    """Every particle present once across the shards."""
    pid = torch.cat([p.to(dist.pid[0].device) for p in dist.pid])
    alive = torch.sort(pid[pid >= 0]).values
    if alive.numel() != n or not torch.equal(
            alive, torch.arange(n, dtype=alive.dtype, device=alive.device)):
        raise AssertionError("%s: %d live slots, not each of the %d "
                             "particles once" % (tag, alive.numel(), n))


def by_pid(dist, field, n):
    """A decomposed state's ``field`` as one ``[n, ...]`` tensor in pid
    order on the first shard's device (absent particles 0)."""
    dev0 = dist.pid[0].device
    pid = torch.cat([p.to(dev0) for p in dist.pid]).long()
    vals = torch.cat([t.to(dev0) for t in getattr(dist, field)])
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    out[pid[pid >= 0]] = vals[pid >= 0]
    return out


def check_change(name, got, want, before, rounding, period=None):
    """The step's change of a field: ``|got - want| <= 1e-5 max|d| + 1e-4
    |d| + rounding`` on every particle, ``d = want - before`` (the
    minimum image on the axes of extent ``period``); raises when the
    plain step left the field unchanged.  Returns the largest
    ``|got - want| / max|d|``."""
    d = want - before
    if period is not None:
        d = d - period * torch.round(d / period)
    scale = d.abs().max()
    if not float(scale) > 0.0:
        raise AssertionError("%s: the plain step did not change it" % name)
    err = (got - want).abs()
    bad = err > 1e-5 * scale + 1e-4 * d.abs() + rounding
    if bool(bad.any()):
        raise AssertionError(
            "%s: the change differs on %d of %d values (max %.3g on a largest "
            "change of %.3g)" % (name, int(bad.sum()), bad.numel(),
                                 float(err.max()), float(scale)))
    return float(err.max() / scale)


def hold_decomp_vs_plain(tag, before, got, want, mode, n, du=False,
                         period=None):
    """One decomposed kernel step ``got = (state, aux)`` from ``before``
    (``n`` particles) against the plain decomposed step ``want`` from the
    same state at phase 5's step tolerances: the same pids in every slot,
    positions rtol 1e-5 atol 1e-6, velocities rtol 1e-4 atol 1e-5 scaled
    by max|v|, summation density rtol 1e-5 atol 1e-6 scaled (continuity's
    rtol 1e-4 atol 1e-2), du/dt rtol 1e-4 atol 1e-5 scaled.  One step
    moves x by only dt^2 a, so the step's CHANGE of each particle's v, x
    and carried rho is held too (:func:`check_change`, with the rounding
    of the field itself: 2^-21 |v| and |x|, four units in the last
    place, and ``RHO_ROUNDING``): a wrong acceleration, XSPH,
    surface-tension or drho/dt sum moves it.

    A periodic run (``period``: ``[3]`` box extents) holds the change of
    x and rho but not of v: in the still box the net acceleration is the
    small remainder of pressure sums that cancel, and the rounding of
    those sums is not small against it (the kernels' ghost positions x +
    L and the plain passes' minimum image already round a separation
    across a face differently).  Returns the max abs errors and the
    changes' scaled ones."""
    (sk, ak), (sp, ap) = got, want
    for d, (a, b) in enumerate(zip(sk.pid, sp.pid)):
        if not torch.equal(a, b):
            raise AssertionError("%s: shard %d holds other pids than the "
                                 "plain step's" % (tag, d))
    if dist_overflow(ak) != dist_overflow(ap):
        raise AssertionError("%s: overflow %s, plain %s"
                             % (tag, dist_overflow(ak), dist_overflow(ap)))
    live = torch.cat([p >= 0 for p in sk.pid])
    xk, xp = torch.cat(sk.x), torch.cat(sp.x)
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-6)
    errs = {"x": float((xk - xp).abs().max())}
    errs["v"] = check_scaled(tag + " v", torch.cat(sk.v), torch.cat(sp.v),
                             live, 1e-4, 1e-5)
    changed = ("x",) if period is not None else ("v", "x")
    for name in changed + (("rho",) if mode == "continuity" else ()):
        f0, fk, fp = (by_pid(st, name, n) for st in (before, sk, sp))
        rounding = (RHO_ROUNDING if name == "rho"
                    else 2.0 ** -21 * torch.maximum(fp.abs(), f0.abs()))
        errs["d" + name] = check_change(
            "%s change of %s" % (tag, name), fk, fp, f0, rounding,
            period if name == "x" else None)
    if mode == "continuity":
        rk, rp = torch.cat(sk.rho), torch.cat(sp.rho)
        torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-2)
        errs["rho"] = float((rk - rp).abs().max())
    else:
        errs["rho"] = check_scaled(tag + " rho", torch.cat(ak.rho),
                                   torch.cat(ap.rho), live, 1e-5, 1e-6)
    if du:
        errs["du"] = check_scaled(tag + " du/dt", torch.cat(ak.dudt),
                                  torch.cat(ap.dudt), live, 1e-4, 1e-5)
    return errs


def held(errs):
    """The printout of :func:`hold_decomp_vs_plain`'s readings."""
    changes = ", ".join("of %s %.3g" % (k[1:], errs[k])
                        for k in ("dv", "dx", "drho") if k in errs)
    return ("max abs x %.3g, v %.3g, rho %.3g%s; the step's change %s of "
            "its largest" % (errs["x"], errs["v"], errs["rho"],
                             ", du/dt %.3g" % errs["du"] if "du" in errs
                             else "", changes))


def phase_decomp_vs_global(dev, card, devices, time_steps=True):
    """Phase 10: the 1M dam break on a mesh of ``devices`` (two shards):
    spill at the auto K = 32 and single tier at K = 128, both modes, 3
    decomposed steps from phase 3's jittered state: every particle once,
    overflow 0, collected x and v against the port's global kernel step
    at the reference's decomposition tolerances; the first step against
    the plain decomposed step from the same state at phase 5's tolerances;
    the launches of one step (shards x the global step's count a role);
    with ``time_steps`` both steps timed (CUDA events, 20 steps) and the
    spill summation step profiled as phase 7 profiles the global step.
    Returns the launches of one step of each path."""
    db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    if (db.n, tuple(db.grid.dims), db.grid.capacity) != (
            N_1M_PARTICLES, DIMS_1M, K_1M):
        raise AssertionError("1M dam break: N=%d grid %s K=%d"
                             % (db.n, db.grid.dims, db.grid.capacity))
    mesh = make_mesh(devices=devices)
    where = ", ".join(str(d) for d in mesh.devices)
    launches, ms = {}, {}
    for k in (K_1M, K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            path = ("wide " if layout == "wide" else "") + mode
            tag = "phase 10 (1M %s K=%d %s on %s)" % (layout, k, mode, where)
            state = slab_state(db, grid, dev, mode)
            step_g = make_step_fn(grid, db.params, density_mode=mode,
                                  device=dev)
            dist, cap = distribute_state(state, grid, mesh)
            step_d = make_distributed_step_fn(grid, db.params, mesh,
                                              capacity=cap, density_mode=mode)
            step_p = make_distributed_step_fn(
                grid, db.params, mesh, capacity=cap, density_mode=mode,
                use_kernels=False, spill=layout == "spill")
            if step_d.resolved != step_g.resolved:
                raise AssertionError("%s: resolved %r, global %r" % (
                    tag, step_d.resolved, step_g.resolved))
            d1, aux, counts = counted_step(step_d, dist)
            want = decomp_launches(path, mesh.size)
            if counts != want:
                raise AssertionError("%s: launches %s, expected %s"
                                     % (tag, counts, want))
            launches["decomposed " + path] = counts
            t0 = time.perf_counter()
            errs = hold_decomp_vs_plain(tag, dist, (d1, aux), step_p(dist),
                                        mode, db.n)
            plain_s = time.perf_counter() - t0
            sd, sg = d1, state
            sg, _aux_g = step_g(sg)
            for _ in range(2):
                sd, aux = step_d(sd)
                sg, _aux_g = step_g(sg)
            if dist_overflow(aux) != (0, 0):
                raise AssertionError("%s: overflow %s" % (tag,
                                                          dist_overflow(aux)))
            check_complete(tag, sd, db.n)
            got = collect_state(sd, db.n)
            np.testing.assert_allclose(got.x, sg.x.cpu().numpy(), **DECOMP_X)
            np.testing.assert_allclose(got.v, sg.v.cpu().numpy(), **DECOMP_V)
            ex = float(np.abs(got.x - sg.x.cpu().numpy()).max())
            ev = float(np.abs(got.v - sg.v.cpu().numpy()).max())
            msg = ("%s: N=%d, %d slots a shard, 3 steps: every particle once, "
                   "overflow 0, against the global kernel step max abs x "
                   "%.3g (rtol 5e-4, atol 5e-5), v %.3g (rtol 5e-3, atol "
                   "5e-3); step 1 against the plain decomposed step (%.1f "
                   "s): pids equal, %s; launches a step %s"
                   % (tag, db.n, cap, ex, ev, plain_s, held(errs),
                      json.dumps(counts)))
            if time_steps:
                ms[path] = (step_ms(step_d, dist, 20, 2),
                            step_ms(step_g, state, 20, 2))
                msg += ("; decomposed %.4f ms/step, global %.4f ms/step "
                        "(CUDA events over 20 steps; %d shards on one "
                        "device measure the decomposition's overhead, not "
                        "scaling)" % (ms[path][0], ms[path][1], mesh.size))
            print(msg + " [%s]" % card)
            if time_steps and path == "summation":
                box = [dist]

                def run():
                    box[0], _aux = step_d(box[0])

                profile_run(run, db.n, 10, 2, "phase 10",
                            "1M decomposed spill summation, %d shards on "
                            "one device" % mesh.size, card)
                del box
            del state, dist, d1, sd, sg, step_p
            torch.cuda.empty_cache()
    return launches, ms


def crossings(before, after, n_shards, n):
    """Particles that crossed each face ``d | d + 1`` (either way)
    between two decomposed states of ``n`` particles."""
    owner = []
    for st in (before, after):
        pid = np.concatenate([p.cpu().numpy() for p in st.pid])
        shard = np.repeat(np.arange(n_shards), pid.shape[0] // n_shards)
        own = np.full(n, -1)
        own[pid[pid >= 0]] = shard[pid >= 0]
        owner.append(own)
    a, b = owner
    return [int(((a == d) & (b == d + 1)).sum() + ((a == d + 1) & (b == d))
                .sum()) for d in range(n_shards - 1)]


def phase_decomp_options(dev, card):
    """Phase 10: the 4-shard mesh on one device with ``xsph=0.5,
    surface_tension=0.05, compute_energy=True``, spill and single tier
    (K = 128), summation: 5 kernel steps from the jittered state
    (velocities N(0, 10^2)) with particles crossing every face, each step held against the plain
    decomposed step from the same state, migrate overflow 0."""
    db = dam_break(capacity="auto", capacity_headroom=1.15, device=dev,
                   **DECOMP_4)
    if (db.n, tuple(db.grid.dims)) != (DECOMP_4_N, DECOMP_4_DIMS):
        raise AssertionError("4-shard dam break: N=%d grid %s"
                             % (db.n, db.grid.dims))
    mesh = make_mesh(devices=[dev] * 4)
    for k in (min(max(db.grid.capacity, 24), 64), K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        tag = "phase 10 (4 shards, %s K=%d with options)" % (layout, k)
        state = slab_state(db, grid, dev, "summation")
        # the lattice planes lie half a spacing from each face: velocities
        # of N(0, 10^2) carry particles across every face within 5 steps
        state = state._replace(v=DECOMP_4_V * state.v)
        dist0, cap = distribute_state(state, grid, mesh)
        kw = dict(capacity=cap, **DECOMP_OPTIONS)
        step_k = make_distributed_step_fn(grid, db.params, mesh, **kw)
        step_p = make_distributed_step_fn(grid, db.params, mesh,
                                          use_kernels=False,
                                          spill=layout == "spill", **kw)
        dist, errs = dist0, {}
        for _ in range(5):
            got = step_k(dist)
            e = hold_decomp_vs_plain(tag, dist, got, step_p(dist),
                                     "summation", db.n, du=True)
            errs = {key: max(errs.get(key, 0.0), v) for key, v in e.items()}
            dist, aux = got
            if dist_overflow(aux)[1]:
                raise AssertionError("%s: migrate overflow" % tag)
        faces = crossings(dist0, dist, mesh.size, db.n)
        if min(faces) == 0:
            raise AssertionError("%s: no crossing of a face: %s" % (tag,
                                                                    faces))
        check_complete(tag, dist, db.n)
        print("%s: dam_break(%s), N=%d, grid %s, %d slots a shard, "
              "velocities N(0, %g^2); 5 steps each held against the plain "
              "decomposed step: pids equal, %s; migrate overflow 0; "
              "particles that crossed faces 0|1, 1|2, 2|3: %s [%s]"
              % (tag, ", ".join("%s=%s" % kv for kv in DECOMP_4.items()),
                 db.n, "x".join(map(str, grid.dims)), cap, DECOMP_4_V,
                 held(errs), faces, card))


def phase_decomp_periodic(dev, card):
    """Phase 10: the periodic 1M still box on a ring of 2 shards, spill K
    = 48, both modes, 20 steps: phase 4's density limits (mean within 2%
    of rho0, every particle within 1% of the mean), every particle once,
    the launches of the global periodic step on each shard; one step
    against the plain decomposed step from the box with seeded N(0, 1)
    velocities, as the 1M holds' jittered state has (at rest the
    lattice's accelerations are the rounding of sums that cancel)."""
    sc = still_box(n_side=N_BOX_1M, device=dev)
    grid = sc.grid._replace(capacity=48)
    mesh = make_mesh(devices=[dev] * DECOMP_SHARDS)
    period = grid.cell_size * torch.tensor(grid.dims, dtype=torch.float32,
                                           device=dev)
    for mode in PATHS_MODES:
        tag = "phase 10 (periodic still box, ring of %d, spill K=48 %s)" % (
            mesh.size, mode)
        state = sc.state
        if mode == "continuity":
            state = init_density(state, grid, sc.params, periodic=True,
                                 device=dev)
        dist, cap = distribute_state(state, grid, mesh)
        kw = dict(capacity=cap, periodic=True, density_mode=mode)
        step = make_distributed_step_fn(grid, sc.params, mesh, **kw)
        step_p = make_distributed_step_fn(grid, sc.params, mesh,
                                          use_kernels=False, spill=True, **kw)
        first, aux, counts = counted_step(step, dist)
        if counts != decomp_launches(mode, mesh.size):
            raise AssertionError("%s: launches %s" % (tag, counts))
        rng = np.random.default_rng(5)
        moving = dist._replace(v=tuple(
            v + torch.where((p >= 0)[:, None], torch.from_numpy(
                rng.standard_normal(tuple(v.shape)).astype(np.float32)
            ).to(dev), 0.0) for v, p in zip(dist.v, dist.pid)))
        errs = hold_decomp_vs_plain(tag, moving, step(moving),
                                    step_p(moving), mode, sc.n,
                                    period=period)
        dist = first
        for _ in range(19):
            dist, aux = step(dist)
        if dist_overflow(aux) != (0, 0):
            raise AssertionError("%s: overflow %s" % (tag,
                                                      dist_overflow(aux)))
        check_complete(tag, dist, sc.n)
        rho = torch.tensor(collect_aux(dist, aux, sc.n, sc.params)[0])
        mean = float(rho.mean())
        spread = float((rho / mean - 1.0).abs().max())
        if abs(mean / 1000.0 - 1.0) > 0.02 or spread > 0.01:
            raise AssertionError("%s: mean density %.4f, largest deviation "
                                 "%.4f" % (tag, mean, spread))
        print("%s: N=%d, 20 steps, mean density %.4f, every particle within "
              "%.2e of the mean (limit 1e-2), every particle once, launches "
              "a step %s; a step with N(0, 1) velocities against the "
              "plain decomposed step: pids equal, %s [%s]"
              % (tag, sc.n, mean, spread, json.dumps(counts), held(errs),
                 card))


def phase_decomp_adaptive(dev, card):
    """Phase 10: the adaptive decomposed step at ``dt == params.dt``
    against the fixed one bit for bit (1M, 2 shards, spill, both modes, 2
    steps), then a 200-step ``run_adaptive`` rollout (summation) under
    ``torch.cuda.set_sync_debug_mode("error")``; returns its final state
    and the mesh for the resume."""
    db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    mesh = make_mesh(devices=[dev] * DECOMP_SHARDS)
    for mode in PATHS_MODES:
        tag = "phase 10 (adaptive 1M spill %s)" % mode
        state = db.state
        if mode == "continuity":
            state = init_density(state, db.grid, db.params, device=dev)
        dist, cap = distribute_state(state, db.grid, mesh)
        kw = dict(capacity=cap, density_mode=mode)
        fixed = make_distributed_step_fn(db.grid, db.params, mesh, **kw)
        adaptive = make_adaptive_distributed_step_fn(db.grid, db.params, mesh,
                                                     **kw)
        df, da = dist, dist
        dt = initial_dt(db.params.dt, dev)[0]
        for _ in range(2):
            df, _ = fixed(df)
            da, _, _dt_next = adaptive(da, dt)
        for name in ("x", "v", "pid", "rho"):
            a, b = getattr(da, name), getattr(df, name)
            if a is not None and not all(torch.equal(p, q)
                                         for p, q in zip(a, b)):
                raise AssertionError("%s: %s differs from the fixed step"
                                     % (tag, name))
        print("%s: 2 steps at dt = params.dt bit-identical to the fixed "
              "decomposed step (x, v, pid%s) [%s]"
              % (tag, ", rho" if mode == "continuity" else "", card))
    dist, cap = distribute_state(db.state, db.grid, mesh)
    step = make_adaptive_distributed_step_fn(db.grid, db.params, mesh,
                                             capacity=cap)
    step(dist, initial_dt(db.params.dt, dev)[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dt, t = run_adaptive(step, dist, db.params.dt, N_ROLLOUT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (0.0 < float(dt) <= float(np.float32(db.params.dt))
            and float(t) > 0.0):
        raise AssertionError("phase 10 rollout: dt %r, t %r" % (float(dt),
                                                                float(t)))
    check_complete("phase 10 rollout", out, db.n)
    if not all(bool(torch.isfinite(x).all()) for x in out.x):
        raise AssertionError("phase 10 rollout: non-finite positions")
    print("phase 10 (adaptive rollout): %d adaptive decomposed steps (1M, "
          "%d shards, spill summation) under sync debug mode \"error\": 0 "
          "host syncs, %.4f ms/step (host clock), t = %.6g s, dt_next = "
          "%.6g [%s]" % (N_ROLLOUT, mesh.size, 1e3 * wall / N_ROLLOUT,
                         float(t), float(dt), card))
    return db


def phase_decomp_resume(dev, card, db):
    """Phase 10: 2 frames (position, velocity, carried density) from the
    2-shard continuity run written by the port's writer; the file resumed
    with ``resume_distributed`` onto 1 shard and onto 2, each state the
    last frame's, one step each (the two held at the decomposition
    tolerances), a frame appended, ``pypgsd.verify(deep=True)``."""
    tag = "phase 10 (resume)"
    state = init_density(db.state, db.grid, db.params, device=dev)
    mesh2 = make_mesh(devices=[dev] * DECOMP_SHARDS)
    dist, cap = distribute_state(state, db.grid, mesh2)
    kw = dict(density_mode="continuity")
    step2 = make_distributed_step_fn(db.grid, db.params, mesh2, capacity=cap,
                                     **kw)
    fd, path = tempfile.mkstemp(suffix=".gsd")
    os.close(fd)
    try:
        writer = ShardedFrameWriter(path, application="tpgsd_torch.chip_smoke",
                                    comm=SingleComm())
        for i in range(2):
            dist, _aux = step2(dist)
            got = collect_state(dist, db.n)
            writer.write_frame({"particles/position": got.x,
                                "particles/velocity": got.v,
                                "particles/density": got.rho}, step=i)
        writer.close()
        after = {}
        for n_sh in (1, DECOMP_SHARDS):
            mesh = make_mesh(devices=[dev] * n_sh)
            t0 = time.perf_counter()
            res, rcap, last, w = resume_distributed(path, db.grid, mesh,
                                                    density_mode="continuity")
            resume_s = time.perf_counter() - t0
            back = collect_state(res, db.n)
            if last != 1 or not (np.array_equal(back.x, got.x)
                                 and np.array_equal(back.v, got.v)
                                 and np.array_equal(back.rho, got.rho)):
                raise AssertionError("%s: the state resumed onto %d shards "
                                     "is not the last frame" % (tag, n_sh))
            step = make_distributed_step_fn(db.grid, db.params, mesh,
                                            capacity=rcap, **kw)
            res, aux = step(res)
            if dist_overflow(aux) != (0, 0):
                raise AssertionError("%s: overflow" % tag)
            after[n_sh] = collect_state(res, db.n)
            if n_sh == DECOMP_SHARDS:
                w.write_frame({"particles/position": after[n_sh].x,
                               "particles/velocity": after[n_sh].v,
                               "particles/density": after[n_sh].rho}, step=2)
            w.close()
            print("%s: the 2-frame file resumed onto %d shard(s) (%d slots a "
                  "shard) in %.3f s (host clock), state equal to the last "
                  "frame, one step taken" % (tag, n_sh, rcap, resume_s))
        np.testing.assert_allclose(after[1].x, after[DECOMP_SHARDS].x,
                                   **DECOMP_X)
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        with tpgsd_torch.hoomd.open(path, mode="r") as traj:
            steps = [int(f.configuration.step) for f in traj]
            last_x = traj[-1].particles.position
        if (not report["ok"] or steps != [0, 1, 2]
                or not np.array_equal(last_x, after[DECOMP_SHARDS].x)):
            raise AssertionError("%s: file %s, steps %s" % (tag, report,
                                                            steps))
        print("%s: 1-shard and 2-shard steps agree (max abs x %.3g); frame "
              "appended, pypgsd.verify(deep=True) ok, steps %s [%s]"
              % (tag, float(np.abs(after[1].x - after[DECOMP_SHARDS].x).max()),
                 steps, card))
    finally:
        os.remove(path)


def phase_decomp_options_launches(dev, card):
    """Phase 10: one decomposed 1M step with ``xsph=0.5,
    surface_tension=0.05, compute_energy=True`` on each layout and mode:
    the option roles' launches a step (shards x the global step's, plus
    the energy passes), and the step held against the plain decomposed
    step from the same state (:func:`hold_decomp_vs_plain`, du/dt
    included)."""
    db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    mesh = make_mesh(devices=[dev] * DECOMP_SHARDS)
    launches = {}
    for k in (K_1M, K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            path = ("wide " if layout == "wide" else "") + "options " + mode
            state = slab_state(db, grid, dev, mode)
            dist, cap = distribute_state(state, grid, mesh)
            step = make_distributed_step_fn(grid, db.params, mesh,
                                            capacity=cap, density_mode=mode,
                                            **DECOMP_OPTIONS)
            step_p = make_distributed_step_fn(
                grid, db.params, mesh, capacity=cap, density_mode=mode,
                use_kernels=False, spill=layout == "spill", **DECOMP_OPTIONS)
            out, aux, counts = counted_step(step, dist)
            energy = ({"energy_wide": 1} if layout == "wide"
                      else {"energy_self": 2, "energy_cross": 2})
            want = decomp_launches(path, mesh.size)
            for key, v in energy.items():
                want[key] = v * mesh.size
            if counts != want:
                raise AssertionError("phase 10 (1M %s): launches %s, "
                                     "expected %s" % (path, counts, want))
            if not bool(torch.cat(aux.dudt).any()):
                raise AssertionError("phase 10 (1M %s): du/dt is 0" % path)
            launches["decomposed " + path] = counts
            t0 = time.perf_counter()
            errs = hold_decomp_vs_plain("phase 10 (1M %s)" % path, dist,
                                        (out, aux), step_p(dist), mode, db.n,
                                        du=True)
            print("phase 10 (1M %s with %s): launches a decomposed step %s; "
                  "against the plain decomposed step (%.1f s): pids equal, %s "
                  "[%s]" % (path, json.dumps(DECOMP_OPTIONS),
                            json.dumps(counts), time.perf_counter() - t0,
                            held(errs), card))
            del state, dist, out, aux, step_p
            torch.cuda.empty_cache()
    return launches


def phase_decomposition(dev, card):
    """Phase 10: the slab decomposition on the card; returns each role's
    launches in one decomposed 1M step and the ms/step pairs."""
    launches, ms = phase_decomp_vs_global(dev, card, [dev] * DECOMP_SHARDS)
    if torch.cuda.device_count() > 1:
        phase_decomp_vs_global(
            dev, card, [torch.device("cuda", i) for i in range(DECOMP_SHARDS)],
            time_steps=False)
    else:
        print("phase 10: one visible CUDA device: the shards share cuda:0, "
              "so cross-device copies were not exercised on this machine")
    phase_decomp_options(dev, card)
    phase_decomp_periodic(dev, card)
    db = phase_decomp_adaptive(dev, card)
    phase_decomp_resume(dev, card, db)
    del db
    launches.update(phase_decomp_options_launches(dev, card))
    per_role = {}
    for counts in launches.values():
        for key, v in counts.items():
            per_role[key] = max(per_role.get(key, 0), v)
    return per_role, launches, ms


# --------------------------------------------------------------------------
# phase 11: the 2-D and 3-D block decompositions
# --------------------------------------------------------------------------

#: the 1M dam break whose 84 x 42 x 42 cells divide by the (2, 2) and (2,
#: 2, 2) meshes, the reference benchmark's fits at 4 and 8 devices
#: (benchmarks/benchmark_sph.py:160-178); phase 9 steps it on 12 slabs
BLOCK_1M = dict(n_side=SLAB_1M[0], capacity="auto", capacity_headroom=1.15)
#: the cube of the options case: every block populated
BLOCK_CUBE = {"n_side": 48, "box": (1.0, 1.0, 1.0), "fill": (1.0, 1.0, 1.0)}
BLOCK_CUBE_N, BLOCK_CUBE_DIMS = 110592, (18, 18, 18)
#: the reference's degenerate-mesh tolerances
#: (tests/test_distributed3d.py:200-265)
DEGENERATE_X, DEGENERATE_V = (dict(rtol=1e-5, atol=1e-6),
                              dict(rtol=1e-4, atol=1e-5))


def block_forms():
    """The two block forms: their mesh shape and entry points."""
    return {
        "2d": dict(shape=(2, 2), mesh=make_mesh2d,
                   distribute=distribute_state_2d,
                   step=make_distributed2d_step_fn,
                   adaptive=make_adaptive_distributed2d_step_fn,
                   resume=resume_distributed2d),
        "3d": dict(shape=(2, 2, 2), mesh=make_mesh3d,
                   distribute=distribute_state_3d,
                   step=make_distributed3d_step_fn,
                   adaptive=make_adaptive_distributed3d_step_fn,
                   resume=resume_distributed3d),
    }


def block_dam_break(dev):
    db = dam_break(device=dev, **BLOCK_1M)
    if (db.n, tuple(db.grid.dims), db.grid.capacity) != (
            SLAB_1M[1], SLAB_1M[2], K_1M):
        raise AssertionError("phase 11 dam break: N=%d grid %s K=%d"
                             % (db.n, db.grid.dims, db.grid.capacity))
    return db


def populations(dist):
    return [int((p >= 0).sum()) for p in dist.pid]


def block_owners(dist, shape, n):
    """``[len(shape), n]``: each particle's block coordinates."""
    pid = np.concatenate([p.cpu().numpy() for p in dist.pid])
    shard = np.repeat(np.arange(len(dist.pid)), dist.pid[0].shape[0])
    own = np.full(n, -1)
    own[pid[pid >= 0]] = shard[pid >= 0]
    return np.stack(np.unravel_index(own, shape))


def block_crossings(before, after, shape, n):
    """``(faces, diagonal)``: the particles that crossed each face of each
    decomposed axis between two states (``faces[axis][f]``: face ``f |
    f + 1``, either way), and those whose block changed on every axis."""
    a, b = block_owners(before, shape, n), block_owners(after, shape, n)
    faces = [[int((((a[ax] == f) & (b[ax] == f + 1))
                   | ((a[ax] == f + 1) & (b[ax] == f))).sum())
              for f in range(shape[ax] - 1)] for ax in range(len(shape))]
    return faces, int((a != b).all(axis=0).sum())


def phase_block_vs_global(dev, card, devices=None):
    """Phase 11: the 1M dam break (n_side=88) on the (2, 2) and (2, 2, 2)
    meshes, spill at the auto K = 32 and single tier at K = 128, both
    modes: 3 block kernel steps from the jittered state against the
    global kernel step at the reference's decomposition tolerances, the
    first against the plain block step from the same state, every
    particle once, overflow 0, the launches of a step (shards x the
    global step's); then one counted step with the options for the
    option roles' launches.  With ``devices`` only the 2-D spill
    summation step, its shards on those devices.  Returns each form's
    launches a role and path."""
    db = block_dam_break(dev)
    launches = {"2d": {}, "3d": {}}
    forms = block_forms()
    for form in ("2d", "3d") if devices is None else ("2d",):
        f = forms[form]
        shape = f["shape"]
        n_sh = int(np.prod(shape))
        mesh = f["mesh"](shape=shape, devices=devices or [dev] * n_sh)
        where = ", ".join(sorted({str(d) for d in mesh.devices}))
        for k in (K_1M, K_WIDE) if devices is None else (K_1M,):
            layout = "wide" if k > 64 else "spill"
            grid = db.grid._replace(capacity=k)
            for mode in PATHS_MODES if devices is None else ("summation",):
                path = ("wide " if layout == "wide" else "") + mode
                tag = "phase 11 (%s %s 1M %s K=%d %s on %s)" % (
                    form, shape, layout, k, mode, where)
                state = slab_state(db, grid, dev, mode)
                step_g = make_step_fn(grid, db.params, density_mode=mode,
                                      device=dev)
                dist, cap = f["distribute"](state, grid, mesh)
                step_d = f["step"](grid, db.params, mesh, capacity=cap,
                                   density_mode=mode)
                step_p = f["step"](grid, db.params, mesh, capacity=cap,
                                   density_mode=mode, use_kernels=False,
                                   spill=layout == "spill")
                if step_d.resolved != step_g.resolved:
                    raise AssertionError("%s: resolved %r, global %r" % (
                        tag, step_d.resolved, step_g.resolved))
                d1, aux, counts = counted_step(step_d, dist)
                want = decomp_launches(path, n_sh)
                if counts != want:
                    raise AssertionError("%s: launches %s, expected %s"
                                         % (tag, counts, want))
                launches[form][path] = counts
                t0 = time.perf_counter()
                errs = hold_decomp_vs_plain(tag, dist, (d1, aux),
                                            step_p(dist), mode, db.n)
                plain_s = time.perf_counter() - t0
                del step_p
                sd, sg = d1, state
                sg, _aux_g = step_g(sg)
                for _ in range(2):
                    sd, aux = step_d(sd)
                    sg, _aux_g = step_g(sg)
                if dist_overflow(aux) != (0, 0):
                    raise AssertionError("%s: overflow %s"
                                         % (tag, dist_overflow(aux)))
                check_complete(tag, sd, db.n)
                got = collect_state(sd, db.n)
                np.testing.assert_allclose(got.x, sg.x.cpu().numpy(),
                                           **DECOMP_X)
                np.testing.assert_allclose(got.v, sg.v.cpu().numpy(),
                                           **DECOMP_V)
                ex = float(np.abs(got.x - sg.x.cpu().numpy()).max())
                ev = float(np.abs(got.v - sg.v.cpu().numpy()).max())
                print("%s: N=%d, %d slots a shard, populations %s; 3 steps: "
                      "every particle once, overflow 0, against the global "
                      "kernel step max abs x %.3g (rtol 5e-4, atol 5e-5), v "
                      "%.3g (rtol 5e-3, atol 5e-3); step 1 against the plain "
                      "block step (%.1f s): pids equal, %s; launches a step "
                      "%s [%s]" % (tag, db.n, cap, populations(dist), ex, ev,
                                   plain_s, held(errs), json.dumps(counts),
                                   card))
                if devices is None:
                    # the option roles' launches in one 1M block step
                    opt_path = (("wide " if layout == "wide" else "")
                                + "options " + mode)
                    step_o = f["step"](grid, db.params, mesh, capacity=cap,
                                       density_mode=mode, **DECOMP_OPTIONS)
                    _o, aux_o, counts_o = counted_step(step_o, dist)
                    want = decomp_launches(opt_path, n_sh)
                    energy = ({"energy_wide": 1} if layout == "wide"
                              else {"energy_self": 2, "energy_cross": 2})
                    for key, v in energy.items():
                        want[key] = v * n_sh
                    if counts_o != want or not bool(
                            torch.cat(aux_o.dudt).any()):
                        raise AssertionError("%s: options launches %s, "
                                             "expected %s" % (tag, counts_o,
                                                              want))
                    launches[form][opt_path] = counts_o
                    del step_o, _o, aux_o
                del state, dist, d1, sd, sg, got
                torch.cuda.empty_cache()
    return launches


def phase_block_degenerate(dev, card):
    """Phase 11: the degenerate meshes with kernels, spill and summation,
    3 steps: the 2-D (2, 1) mesh against the slab step on 2 shards (the
    1M dam break of phase 10, n_side=86), the 3-D (2, 2, 1) mesh against
    the 2-D (2, 2) mesh (n_side=88), at the reference's degenerate
    tolerances."""
    forms = block_forms()
    for n_side, (name_a, make_a), (name_b, make_b) in (
            (N_1M, ("slab, 2 shards", None), ("2-D (2, 1)", ("2d", (2, 1)))),
            (SLAB_1M[0], ("2-D (2, 2)", ("2d", (2, 2))),
             ("3-D (2, 2, 1)", ("3d", (2, 2, 1))))):
        db = dam_break(n_side=n_side, capacity="auto", capacity_headroom=1.15,
                       device=dev)
        state = slab_state(db, db.grid, dev, "summation")
        out, cap = [], None
        for make in (make_a, make_b):
            if make is None:
                mesh = make_mesh(devices=[dev] * 2)
                dist, cap = distribute_state(state, db.grid, mesh,
                                             capacity=cap)
                step = make_distributed_step_fn(db.grid, db.params, mesh,
                                                capacity=cap)
            else:
                f = forms[make[0]]
                mesh = f["mesh"](shape=make[1],
                                 devices=[dev] * int(np.prod(make[1])))
                dist, cap = f["distribute"](state, db.grid, mesh,
                                            capacity=cap)
                step = f["step"](db.grid, db.params, mesh, capacity=cap)
            for _ in range(3):
                dist, aux = step(dist)
            if dist_overflow(aux) != (0, 0):
                raise AssertionError("phase 11 degenerate: overflow")
            check_complete("phase 11 degenerate", dist, db.n)
            out.append(collect_state(dist, db.n))
        np.testing.assert_allclose(out[1].x, out[0].x, **DEGENERATE_X)
        np.testing.assert_allclose(out[1].v, out[0].v, **DEGENERATE_V)
        print("phase 11 (degenerate, N=%d): the %s step against the %s step, "
              "spill summation kernels, 3 steps: max abs x %.3g (rtol 1e-5, "
              "atol 1e-6), v %.3g (rtol 1e-4, atol 1e-5) [%s]"
              % (db.n, name_b, name_a, float(np.abs(out[1].x - out[0].x).max()),
                 float(np.abs(out[1].v - out[0].v).max()), card))
        del db, state, dist, out
        torch.cuda.empty_cache()


def corner_mover(state, db, shape, speed=10.0):
    """The state with one particle moved across the blocks' common corner:
    the particle of block (0, ..) nearest the corner put 0.2 mm from it on
    each decomposed axis, moving at ``speed`` m/s towards the opposite
    block on each (1.5 mm a step at the cube's dt; the viscosity of the
    N(0, 10^2) neighbours slows it by a few m/s in the first step).
    Returns the state and the particle's pid."""
    n_dec = len(shape)
    corner = torch.tensor([db.grid.lo[a] + db.grid.cell_size * db.grid.dims[a]
                           / 2 for a in range(n_dec)], device=state.x.device)
    d = (corner - state.x[:, :n_dec]).clamp(min=0.0)
    inside = (state.x[:, :n_dec] < corner).all(dim=1)
    pid = int(torch.where(inside, d.sum(dim=1), float("inf")).argmin())
    x, v = state.x.clone(), state.v.clone()
    x[pid, :n_dec] = corner - 2e-4
    v[pid, :n_dec] = speed
    return state._replace(x=x, v=v), pid


def phase_block_options(dev, card):
    """Phase 11: the cube (n_side=48, every block populated) with ``xsph=
    0.5, surface_tension=0.05, compute_energy=True`` on the (2, 2) and (2,
    2, 2) meshes, spill and K = 128, summation: 5 kernel steps from the
    jittered state (velocities N(0, 10^2), and one particle moved across
    the blocks' corner), each held against the plain block step from the
    same state (du/dt included); migrate overflow 0, every face of every
    decomposed axis crossed, the diagonal (corner) movers of each step
    counted (at least one, and the moved particle on the opposite block
    at the end).  Returns the 2-D run's states for the resume."""
    db = dam_break(capacity="auto", capacity_headroom=1.15, device=dev,
                   **BLOCK_CUBE)
    if (db.n, tuple(db.grid.dims)) != (BLOCK_CUBE_N, BLOCK_CUBE_DIMS):
        raise AssertionError("phase 11 cube: N=%d grid %s"
                             % (db.n, db.grid.dims))
    keep = None
    for form, f in block_forms().items():
        shape = f["shape"]
        mesh = f["mesh"](shape=shape, devices=[dev] * int(np.prod(shape)))
        for k in (min(max(db.grid.capacity, 24), 64), K_WIDE):
            layout = "wide" if k > 64 else "spill"
            grid = db.grid._replace(capacity=k)
            tag = "phase 11 (%s %s, cube %s K=%d with options)" % (
                form, shape, layout, k)
            state = slab_state(db, grid, dev, "summation")
            state = state._replace(v=DECOMP_4_V * state.v)
            state, mover = corner_mover(state, db, shape)
            dist0, cap = f["distribute"](state, grid, mesh)
            kw = dict(capacity=cap, **DECOMP_OPTIONS)
            step_k = f["step"](grid, db.params, mesh, **kw)
            step_p = f["step"](grid, db.params, mesh, use_kernels=False,
                               spill=layout == "spill", **kw)
            dist, errs, diagonal, states = dist0, {}, [], [dist0]
            for _ in range(5):
                got = step_k(dist)
                e = hold_decomp_vs_plain(tag, dist, got, step_p(dist),
                                         "summation", db.n, du=True)
                errs = {key: max(errs.get(key, 0.0), v)
                        for key, v in e.items()}
                diagonal.append(block_crossings(dist, got[0], shape,
                                                db.n)[1])
                dist, aux = got
                states.append(dist)
                if dist_overflow(aux)[1]:
                    raise AssertionError("%s: migrate overflow" % tag)
            faces, _ = block_crossings(dist0, dist, shape, db.n)
            if min(min(fc) for fc in faces) == 0 or sum(diagonal) == 0:
                raise AssertionError("%s: faces crossed %s, diagonal movers "
                                     "a step %s" % (tag, faces, diagonal))
            moved = block_owners(dist, shape, db.n)[:, mover]
            if not (moved == 1).all():
                raise AssertionError("%s: the corner mover is on block %s"
                                     % (tag, moved))
            check_complete(tag, dist, db.n)
            print("%s: dam_break(%s), N=%d, grid %s, %d slots a shard, "
                  "populations %s, velocities N(0, %g^2) and pid %d moved "
                  "across the corner; 5 steps each held against the plain "
                  "block step: pids equal, %s; migrate overflow 0; particles "
                  "that crossed the faces of x, y%s: %s; movers across every "
                  "decomposed axis in one step, each step: %s [%s]"
                  % (tag, ", ".join("%s=%s" % kv for kv in BLOCK_CUBE.items()),
                     db.n, "x".join(map(str, grid.dims)), cap,
                     populations(dist0), DECOMP_4_V, mover, held(errs),
                     ", z" if len(shape) == 3 else "", faces, diagonal, card))
            if form == "2d" and layout == "spill":
                keep = (db, grid, states)
            del step_p, step_k
    return keep


def phase_block_periodic(dev, card):
    """Phase 11: the periodic 1M still box (38^3 cells) on the (2, 2) mesh
    (x and y through the rings, z through the kernels' ghost halo) and on
    the (2, 2, 2) mesh (all three through the rings), spill K = 48, both
    modes, 20 steps: phase 4's density limits, every particle once, the
    launches of the global periodic step on each shard; one step from
    seeded N(0, 1) velocities against the plain block step (v, and the
    change of x and rho), as phase 10's ring: at N(0, 0.1^2) the
    rounding of the still box's cancelling pressure sums (ghost
    positions x + L in the kernels, the minimum image in the plain
    passes) is above 1e-5 of max|v|."""
    sc = still_box(n_side=N_BOX_1M, device=dev)
    grid = sc.grid._replace(capacity=48)
    period = grid.cell_size * torch.tensor(grid.dims, dtype=torch.float32,
                                           device=dev)
    for form, f in block_forms().items():
        shape = f["shape"]
        n_sh = int(np.prod(shape))
        mesh = f["mesh"](shape=shape, devices=[dev] * n_sh)
        for mode in PATHS_MODES:
            tag = "phase 11 (%s %s periodic still box, spill K=48 %s)" % (
                form, shape, mode)
            state = sc.state
            if mode == "continuity":
                state = init_density(state, grid, sc.params, periodic=True,
                                     device=dev)
            dist, cap = f["distribute"](state, grid, mesh)
            kw = dict(capacity=cap, periodic=True, density_mode=mode)
            step = f["step"](grid, sc.params, mesh, **kw)
            step_p = f["step"](grid, sc.params, mesh, use_kernels=False,
                               spill=True, **kw)
            first, aux, counts = counted_step(step, dist)
            if counts != decomp_launches(mode, n_sh):
                raise AssertionError("%s: launches %s" % (tag, counts))
            rng = np.random.default_rng(5)
            moving = dist._replace(v=tuple(
                v + torch.where((p >= 0)[:, None], torch.from_numpy(
                    rng.standard_normal(tuple(v.shape)).astype(
                        np.float32)).to(dev), 0.0)
                for v, p in zip(dist.v, dist.pid)))
            errs = hold_decomp_vs_plain(tag, moving, step(moving),
                                        step_p(moving), mode, sc.n,
                                        period=period)
            del step_p
            dist = first
            for _ in range(19):
                dist, aux = step(dist)
            if dist_overflow(aux) != (0, 0):
                raise AssertionError("%s: overflow %s"
                                     % (tag, dist_overflow(aux)))
            check_complete(tag, dist, sc.n)
            rho = torch.tensor(collect_aux(dist, aux, sc.n, sc.params)[0])
            mean = float(rho.mean())
            spread = float((rho / mean - 1.0).abs().max())
            if abs(mean / 1000.0 - 1.0) > 0.02 or spread > 0.01:
                raise AssertionError("%s: mean density %.4f, largest "
                                     "deviation %.4f" % (tag, mean, spread))
            print("%s: N=%d, 20 steps, mean density %.4f, every particle "
                  "within %.2e of the mean (limit 1e-2), every particle "
                  "once, launches a step %s; a step with N(0, 1) "
                  "velocities against the plain block step: pids equal, %s "
                  "[%s]" % (tag, sc.n, mean, spread, json.dumps(counts),
                            held(errs), card))
            del dist, first, moving, aux
            torch.cuda.empty_cache()


def phase_block_adaptive(dev, card):
    """Phase 11: each form's adaptive step at ``dt == params.dt`` against
    its fixed step bit for bit (1M, spill, both modes, 2 steps), then a
    200-step ``run_adaptive`` rollout of the (2, 2, 2) step on the cube
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    db = block_dam_break(dev)
    forms = block_forms()
    for form, f in forms.items():
        shape = f["shape"]
        mesh = f["mesh"](shape=shape, devices=[dev] * int(np.prod(shape)))
        for mode in PATHS_MODES:
            tag = "phase 11 (%s %s adaptive 1M spill %s)" % (form, shape,
                                                             mode)
            state = db.state
            if mode == "continuity":
                state = init_density(state, db.grid, db.params, device=dev)
            dist, cap = f["distribute"](state, db.grid, mesh)
            kw = dict(capacity=cap, density_mode=mode)
            fixed = f["step"](db.grid, db.params, mesh, **kw)
            adaptive = f["adaptive"](db.grid, db.params, mesh, **kw)
            df, da = dist, dist
            dt = initial_dt(db.params.dt, dev)[0]
            for _ in range(2):
                df, _ = fixed(df)
                da, _, _dt_next = adaptive(da, dt)
            for name in ("x", "v", "pid", "rho"):
                a, b = getattr(da, name), getattr(df, name)
                if a is not None and not all(torch.equal(p, q)
                                             for p, q in zip(a, b)):
                    raise AssertionError("%s: %s differs from the fixed "
                                         "step" % (tag, name))
            print("%s: 2 steps at dt = params.dt bit-identical to the fixed "
                  "block step (x, v, pid%s) [%s]"
                  % (tag, ", rho" if mode == "continuity" else "", card))
    del db
    cube = dam_break(capacity="auto", capacity_headroom=1.15, device=dev,
                     **BLOCK_CUBE)
    f = forms["3d"]
    mesh = f["mesh"](shape=f["shape"], devices=[dev] * 8)
    dist, cap = f["distribute"](cube.state, cube.grid, mesh)
    step = f["adaptive"](cube.grid, cube.params, mesh, capacity=cap)
    step(dist, initial_dt(cube.params.dt, dev)[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dt, t = run_adaptive(step, dist, cube.params.dt, N_ROLLOUT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (0.0 < float(dt) <= float(np.float32(cube.params.dt))
            and float(t) > 0.0):
        raise AssertionError("phase 11 rollout: dt %r, t %r" % (float(dt),
                                                                float(t)))
    check_complete("phase 11 rollout", out, cube.n)
    if not all(bool(torch.isfinite(x).all()) for x in out.x):
        raise AssertionError("phase 11 rollout: non-finite positions")
    print("phase 11 (3d (2, 2, 2) adaptive rollout): %d adaptive block steps "
          "(the cube, N=%d, spill summation) under sync debug mode "
          "\"error\": 0 host syncs, %.4f ms/step (host clock), t = %.6g s, "
          "dt_next = %.6g [%s]" % (N_ROLLOUT, cube.n, 1e3 * wall / N_ROLLOUT,
                                   float(t), float(dt), card))


def phase_block_resume(dev, card, kept):
    """Phase 11: 2 frames of the 2-D options run of the cube (its last two
    states) written by the port's writer, resumed with
    ``resume_distributed2d`` onto (2, 2) and (1, 1) and with
    ``resume_distributed3d`` onto (2, 2, 2): each state the last frame's,
    one step each (held against each other at the decomposition
    tolerances), a frame appended, ``pypgsd.verify(deep=True)``."""
    db, grid, states = kept
    tag = "phase 11 (resume)"
    forms = block_forms()
    fd, path = tempfile.mkstemp(suffix=".gsd")
    os.close(fd)
    try:
        writer = ShardedFrameWriter(path, application="tpgsd_torch.chip_smoke",
                                    comm=SingleComm())
        for i, st in enumerate(states[-2:]):
            got = collect_state(st, db.n)
            writer.write_frame({"particles/position": got.x,
                                "particles/velocity": got.v}, step=i)
        writer.close()
        after = {}
        for form, shape in (("2d", (2, 2)), ("2d", (1, 1)),
                            ("3d", (2, 2, 2))):
            f = forms[form]
            mesh = f["mesh"](shape=shape,
                             devices=[dev] * int(np.prod(shape)))
            t0 = time.perf_counter()
            res, rcap, last, w = f["resume"](path, grid, mesh)
            resume_s = time.perf_counter() - t0
            back = collect_state(res, db.n)
            if last != 1 or not (np.array_equal(back.x, got.x)
                                 and np.array_equal(back.v, got.v)):
                raise AssertionError("%s: the state resumed onto %s is not "
                                     "the last frame" % (tag, shape))
            step = f["step"](grid, db.params, mesh, capacity=rcap)
            res, aux = step(res)
            if dist_overflow(aux) != (0, 0):
                raise AssertionError("%s: overflow" % tag)
            after[shape] = collect_state(res, db.n)
            if shape == (2, 2, 2):
                w.write_frame({"particles/position": after[shape].x,
                               "particles/velocity": after[shape].v}, step=2)
            w.close()
            print("%s: the 2-frame file resumed onto %s %s (%d slots a "
                  "shard) in %.3f s (host clock), state equal to the last "
                  "frame, one step taken" % (tag, form, shape, rcap,
                                             resume_s))
        ref = after[(1, 1)]
        for shape in ((2, 2), (2, 2, 2)):
            np.testing.assert_allclose(after[shape].x, ref.x, **DECOMP_X)
            np.testing.assert_allclose(after[shape].v, ref.v, **DECOMP_V)
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        with tpgsd_torch.hoomd.open(path, mode="r") as traj:
            steps = [int(fr.configuration.step) for fr in traj]
            last_x = traj[-1].particles.position
        if (not report["ok"] or steps != [0, 1, 2]
                or not np.array_equal(last_x, after[(2, 2, 2)].x)):
            raise AssertionError("%s: file %s, steps %s" % (tag, report,
                                                            steps))
        print("%s: the (2, 2) and (2, 2, 2) steps against the (1, 1) step: "
              "max abs x %.3g, %.3g; frame appended, pypgsd.verify(deep=True) "
              "ok, steps %s [%s]"
              % (tag, float(np.abs(after[(2, 2)].x - ref.x).max()),
                 float(np.abs(after[(2, 2, 2)].x - ref.x).max()), steps,
                 card))
    finally:
        os.remove(path)


def phase_block_times(dev, card):
    """Phase 11: ms/step (CUDA events over 20 steps after 2) of the (2, 2)
    and (2, 2, 2) block steps, the global step and the slab step on 2
    shards, on the same 1M jittered state, for each layout and mode; all
    shards on one device, so the ratios measure the decompositions'
    overhead, not scaling.  Then a profile of the 3-D spill summation
    step.  Returns ``{path: {step: ms}}``."""
    db = block_dam_break(dev)
    forms = block_forms()
    ms = {}
    for k in (K_1M, K_WIDE):
        layout = "wide" if k > 64 else "spill"
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            path = ("wide " if layout == "wide" else "") + mode
            state = slab_state(db, grid, dev, mode)
            row = {"global": step_ms(make_step_fn(grid, db.params,
                                                  density_mode=mode,
                                                  device=dev), state, 20, 2)}
            mesh = make_mesh(devices=[dev] * 2)
            dist, cap = distribute_state(state, grid, mesh)
            row["slab, 2 shards"] = step_ms(make_distributed_step_fn(
                grid, db.params, mesh, capacity=cap, density_mode=mode),
                dist, 20, 2)
            for form, f in forms.items():
                shape = f["shape"]
                mesh = f["mesh"](shape=shape,
                                 devices=[dev] * int(np.prod(shape)))
                dist, cap = f["distribute"](state, grid, mesh)
                step = f["step"](grid, db.params, mesh, capacity=cap,
                                 density_mode=mode)
                row["%s %s" % (form, shape)] = step_ms(step, dist, 20, 2)
                if form == "3d" and path == "summation":
                    box = [dist]

                    def run():
                        box[0], _aux = step(box[0])

                    profile_run(run, db.n, 10, 2, "phase 11",
                                "1M 3-D (2, 2, 2) block spill summation, 8 "
                                "shards on one device", card)
                    del box
            ms[path] = row
            print("phase 11 (1M %s, N=%d): %s ms/step (CUDA events over 20 "
                  "steps; every shard on one device, so this is the "
                  "decompositions' overhead, not scaling) [%s]"
                  % (path, db.n, ", ".join("%s %.4f" % kv
                                           for kv in row.items()), card))
            del state, dist
            torch.cuda.empty_cache()
    return ms


def phase_blocks(dev, card):
    """Phase 11: the 2-D and 3-D block decompositions on the card; returns
    each form's launches a role in one 1M step, and the ms/step rows."""
    launches = phase_block_vs_global(dev, card)
    count = torch.cuda.device_count()
    if count > 1:
        phase_block_vs_global(dev, card, devices=[
            torch.device("cuda", i % count) for i in range(4)])
    else:
        print("phase 11: one visible CUDA device: the blocks share cuda:0, "
              "so cross-device copies were not exercised on this machine")
    phase_block_degenerate(dev, card)
    kept = phase_block_options(dev, card)
    phase_block_periodic(dev, card)
    phase_block_adaptive(dev, card)
    phase_block_resume(dev, card, kept)
    del kept
    ms = phase_block_times(dev, card)
    per_role = {}
    for form, paths in launches.items():
        roles = per_role.setdefault(form, {})
        for counts in paths.values():
            for key, v in counts.items():
                roles[key] = max(roles.get(key, 0), v)
    return per_role, ms


# --------------------------------------------------------------------------
# phase 12: one process per rank (TorchProcessComm over Gloo on cuda:0)
# --------------------------------------------------------------------------

#: the forms over processes: (form, processes, mesh shape, capacities);
#: the 1M dam breaks of phases 10 (slab, n_side=86) and 11 (blocks,
#: n_side=88), one shard a process
MP_FORMS = (("slab", 2, None, (K_1M, K_WIDE)), ("2d", 4, (2, 2), (K_1M,)),
            ("3d", 8, (2, 2, 2), (K_1M,)))
MP_STEPS = 3  # steps of each run, the last held bit for bit
MP_TIMED = 10  # then the steps timed, over processes and in one process
MP_TIMEOUT_S = 240  # the deadline of one spawn of workers


def mp_runs(form, shape, db, ks, dev, write=None):
    """The runs of ``form`` on ``db``: each capacity of ``ks`` in both
    modes, from phase 3's jittered state (continuity seeded with the
    global summation density)."""
    base = slab_state(db, db.grid, dev, "summation")
    x, v = base.x.cpu().numpy(), base.v.cpu().numpy()
    runs = []
    for k in ks:
        grid = db.grid._replace(capacity=k)
        for mode in PATHS_MODES:
            rho = None
            if mode == "continuity":
                rho = init_density(base, grid, db.params,
                                   device=dev).rho.cpu().numpy()
            run = {"kind": "step", "form": form, "shape": shape,
                   "devices": [str(dev)], "grid": grid, "params": db.params,
                   "state": (x, v, rho), "steps": MP_STEPS,
                   "hold": [MP_STEPS - 1], "count": True, "census": True,
                   "time": MP_TIMED, "kw": {"density_mode": mode},
                   "label": "%s K=%d %s" % ("wide" if k > 64 else "spill", k,
                                            mode)}
            if write and not runs:
                run.update(frames=2, write=write)
            runs.append(run)
    del base
    torch.cuda.empty_cache()
    return runs


def summed(counts):
    total = {}
    for c in counts:
        for key, n in c.items():
            total[key] = total.get(key, 0) + n
    return total


def hold_mp_run(tag, run, single, results, j, n, card):
    """One run over processes against the single-controller run: every
    process held its shards bit for bit (in the worker); here overflow 0,
    every particle once, the launches of a step summed over the
    processes equal to the single controller's, and the times."""
    ranks = [res[j] for res in results]
    if single["overflow"] != (0, 0) or any(r["overflow"] != (0, 0)
                                           for r in ranks):
        raise AssertionError("%s: overflow %s" % (tag, [r["overflow"]
                                                        for r in ranks]))
    pids = np.sort(np.concatenate([r["pids"] for r in ranks]))
    if not np.array_equal(pids, np.arange(n, dtype=pids.dtype)):
        raise AssertionError("%s: %d live slots, not each of the %d "
                             "particles once" % (tag, pids.size, n))
    launches = summed(r["launches"] for r in ranks)
    if launches != single["launches"] or not launches:
        raise AssertionError("%s: launches over the processes %s, single "
                             "controller %s" % (tag, launches,
                                                single["launches"]))
    ms_mp = 1e3 * max(r["timed"][0] for r in ranks) / MP_TIMED
    ms_one = 1e3 * single["timed"][0] / MP_TIMED
    syncs = max(r["timed"][2] for r in ranks) / MP_TIMED
    mb = max(r["timed"][3] for r in ranks) / MP_TIMED / 1e6
    ms_sync = 1e3 * max(r["timed"][4] for r in ranks) / MP_TIMED
    ms_x = 1e3 * max(r["timed"][5] for r in ranks) / MP_TIMED
    print("%s: N=%d, %d slots a shard, %d steps: every process's shards "
          "bit-identical to the single-controller step's (x, v, pid%s), "
          "overflow 0, every particle once; launches a step over all "
          "processes %s (= the single controller's); %.4f ms/step over "
          "processes, %.4f ms/step single controller (ratio %.3f; host "
          "clock over %d steps after 2, barrier to barrier); a step a "
          "process at most: %.1f host syncs (%.4f ms waiting in them for "
          "the device and the copies to the host), %.2f MB sent, %.4f ms "
          "in the rest of the cross-process exchanges (Gloo's staging of "
          "the halos and migrant buffers through pinned host memory, host "
          "clock; the single controller makes none) [%s]"
          % (tag, n, single["capacity"], MP_STEPS,
             ", rho" if run["state"][2] is not None else "",
             json.dumps(launches), ms_mp, ms_one, ms_mp / ms_one, MP_TIMED,
             syncs, ms_sync, mb, ms_x, card))
    return launches, (ms_mp, ms_one, syncs, mb, ms_sync, ms_x)


def mp_cycle_files(tag, write, n, cap, card):
    """The dump cycle's files: byte-equal to one process's, every
    particle once in each frame, ``verify(deep=True)``."""
    for kind, path in write.items():
        with open(path, "rb") as a, open(path + ".one", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("%s: the %s file differs from one "
                                     "process's" % (tag, kind))
        with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
            if f.nframes != 2:
                raise AssertionError("%s: %d frames" % (tag, f.nframes))
            for frame in range(2):
                pid = f.read_chunk(frame, "log/pid")
                pos = f.read_chunk(frame, "particles/position")
                if (pos.shape[0] != pid.shape[0]
                        or not np.array_equal(np.sort(pid[pid >= 0]),
                                              np.arange(n, dtype=pid.dtype))
                        or not np.isfinite(pos[pid >= 0]).all()):
                    raise AssertionError("%s: frame %d census" % (tag, frame))
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        if not report["ok"]:
            raise AssertionError("%s: %s" % (tag, report["errors"]))
        print("%s: 2 frames of position, velocity and pid through %s over "
              "TorchProcessComm (%.1f MB; each process wrote its own "
              "shards, %d slots a shard): byte-equal to the same frames "
              "written by one process, every particle once a frame, "
              "pypgsd.verify(deep=True) ok [%s]"
              % (tag, {"sharded": "ShardedFrameWriter",
                       "composed": "ComposedFrameWriter"}[kind],
                 os.path.getsize(path) / 1e6, cap, card))


def phase_kill_controller(card):
    """Phase 12: the controller killed mid-frame over 4 processes (a
    small file): the file reopens at exactly 3 frames."""
    tag = "phase 12 (controller killed)"
    workdir = tempfile.mkdtemp(prefix="tpgsd_mp_kill_")
    try:
        path = os.path.join(workdir, "killed.gsd")
        worker.write_case(workdir, [{"kind": "kill", "path": path}])
        done = launch.spawn(workdir, 4, MP_TIMEOUT_S)
        if done.returncodes[0] != -9 or done.timed_out:
            raise AssertionError("%s: exit codes %s\n%s" % (
                tag, done.returncodes, done.outputs[0][-2000:]))
        data = np.arange(16, dtype=np.float64)
        with tpgsd_torch.pypgsd.PGSDFile(open(path, "rb")) as f:
            if f.nframes != 3 or f.chunk_exists(3, "d") or not all(
                    np.array_equal(f.read_chunk(i, "d"), data + i)
                    for i in range(3)):
                raise AssertionError("%s: %d frames" % (tag, f.nframes))
        if not tpgsd_torch.pypgsd.verify(path, deep=True)["ok"]:
            raise AssertionError("%s: verify" % tag)
        print("%s: 4 processes, rank 0 (the controller, which hosts the "
              "group's store) killed after its frame-3 bytes, before the "
              "index commit: exit codes %s; the file reopens at 3 frames, "
              "pypgsd.verify(deep=True) ok [%s]" % (tag, done.returncodes,
                                                    card))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_nccl_wiring(dev, card):
    """Phase 12: a one-process NCCL group (the only NCCL group one card
    allows): ``TorchProcessComm`` over its own Gloo group beside the NCCL
    default group, the slab step's 2 shards on ``cuda:0`` (exchanged
    within the process) held bit for bit to the single controller, and a
    frame written over the communicator, byte-equal."""
    tag = "phase 12 (NCCL, one process)"
    db = dam_break(n_side=N_100K, capacity="auto", device=dev)
    workdir = tempfile.mkdtemp(prefix="tpgsd_mp_nccl_")
    try:
        run = mp_runs("slab", None, db, (db.grid.capacity,), dev)[0]
        path = os.path.join(workdir, "nccl.gsd")
        run.update(devices=[str(dev)] * 2, steps=2, hold=[1], time=0,
                   frames=1, write={"sharded": path})
        worker.over_processes(workdir, [run], 1, MP_TIMEOUT_S,
                              backend="nccl")
        with open(path, "rb") as a, open(path + ".one", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("%s: the file differs" % tag)
        print("%s: N=%d on 2 shards of cuda:0 in one process of an NCCL "
              "group: bit-identical to the single controller, the frame "
              "byte-equal; this proves the wiring only [%s]"
              % (tag, db.n, card))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_processes(dev, card):
    """Phase 12: the slab (2 processes), (2, 2) (4) and (2, 2, 2) (8)
    decompositions on the 1M dam breaks, one process a shard on
    ``cuda:0`` over Gloo, each run against the single-controller step
    run here; the (2, 2) dump cycle through both writers; the controller
    killed mid-frame; the NCCL wiring.  Returns each form's launches a
    role over all processes in one step, and the times."""
    t0 = time.perf_counter()
    launches, times = {}, {}
    for form, nprocs, shape, ks in MP_FORMS:
        db = (block_dam_break(dev) if form != "slab" else
              dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                        device=dev))
        workdir = tempfile.mkdtemp(prefix="tpgsd_mp_%s_" % form)
        try:
            write = None
            if form == "2d":
                write = {"sharded": os.path.join(workdir, "cycle.gsd"),
                         "composed": os.path.join(workdir, "composed.gsd")}
            runs = mp_runs(form, shape, db, ks, dev, write)
            n = db.n
            del db
            torch.cuda.empty_cache()
            t_form = time.perf_counter()
            singles, results = worker.over_processes(workdir, runs, nprocs,
                                                     MP_TIMEOUT_S)
            spawn_s = time.perf_counter() - t_form
            for j, run in enumerate(runs):
                tag = "phase 12 (1M %s %s, %d processes)" % (
                    form, run["label"], nprocs)
                counts, ms = hold_mp_run(tag, run, singles[j], results, j, n,
                                         card)
                roles = launches.setdefault(form, {})
                for key, v in counts.items():
                    roles[key] = max(roles.get(key, 0), v)
                times["%s %s" % (form, run["label"])] = ms
                if run.get("write"):
                    mp_cycle_files(tag, run["write"], n, singles[j]["capacity"],
                                   card)
            print("phase 12 (1M %s): %d processes, %d runs, %.1f s with the "
                  "single-controller runs and the spawn [%s]"
                  % (form, nprocs, len(runs), spawn_s, card))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    phase_kill_controller(card)
    phase_nccl_wiring(dev, card)
    print("phase 12: one GPU: every process shares cuda:0, so NCCL "
          "point-to-point and cross-device copies were not exercised; the "
          "halos, migrants and CFL maxima between processes went through "
          "Gloo and pinned host memory [%s]" % card)
    print("phase 12 ran %.1f s [%s]" % (time.perf_counter() - t0, card))
    return launches, times


# --------------------------------------------------------------------------
# phase 13: SIGTERM drains the dump; the command line on the card's file
# --------------------------------------------------------------------------

SIGTERM_STEPS = 20  # the terminated run's steps, a frame each
SIGTERM_AFTER = 8  # the parent signals once the child printed this frame
SIGTERM_DEPTH = 4  # frames in flight in the child's dump
SIGTERM_TIMEOUT_S = 180  # the child is killed past this
#: runs the port's CLI as ``python -m tpgsd_torch`` does, with torch, JAX
#: and the JAX package blocked: reading a file needs numpy alone
CLI_WRAPPER = (
    "import runpy, sys\n"
    "for name in ('torch', 'jax', 'tpgsd'):\n"
    "    sys.modules[name] = None\n"
    "runpy.run_module('tpgsd_torch', run_name='__main__', alter_sys=True)\n"
)


def sigterm_frame(state, rho, p, slength):
    """The chunks of one frame of the terminated run."""
    return {"particles/position": state.x, "particles/velocity": state.v,
            "particles/density": rho, "particles/pressure": p,
            "particles/slength": slength}


def sigterm_child(path, h):
    """The run that phase 13 terminates (``chip_smoke.py --sigterm-child
    PATH H``, started by the parent only): the flagship 1M spill
    summation step through ``configuration``, a frame every step through
    the async dump into ``PATH``, ``submitted k`` printed after the k-th
    submit, until SIGTERM arrives; the package's handler turns it into
    ``SystemExit(1)`` and the runner drains on the way out.  Prints the
    frames written when the signal arrived and when the runner closed,
    and the launch counts of the run."""
    dev = torch.device("cuda", 0)
    _build.load()
    step, state = configuration("spill", N_1M, dev, "summation")
    slength = torch.full((state.x.shape[0],), h, device=dev)
    ops.reset_launch_counts()
    writer = ShardedFrameWriter(path, application="tpgsd_torch.chip_smoke",
                                comm=SingleComm(),
                                static={"configuration/box": BOX})
    dump = AsyncDumpRunner(writer, depth=SIGTERM_DEPTH)
    try:
        with dump:
            try:
                for k in range(1, SIGTERM_STEPS + 1):
                    state, (rho, p, _ov) = step(state)
                    dump.submit(sigterm_frame(state, rho, p, slength),
                                step=k - 1)
                    print("submitted %d" % k, flush=True)
                # a signal later than the last frame still finds the run
                time.sleep(SIGTERM_TIMEOUT_S)
            except SystemExit:
                print("signalled: %d frames written" % dump.stats.frames,
                      flush=True)
                raise
    finally:
        print("closed: %d frames written" % dump.stats.frames, flush=True)
        print("launches %s" % json.dumps(dict(ops.launch_counts)),
              flush=True)


def frame_arrays(path, frame):
    """Every chunk of ``frame`` of ``path`` but the static box."""
    with tpgsd_torch.fl.open(path, "r") as f:
        return {name: f.read_chunk(frame, name)
                for name in f.find_matching_chunk_names("")
                if name != "configuration/box" and f.chunk_exists(frame, name)}


def truncated_copy(path, out):
    """``out``: ``path`` cut in the middle of its last frame's position
    data; returns the cut."""
    with tpgsd_torch.fl.open(path, "r") as f:
        chunk = f._find_chunk(f.nframes - 1, "particles/position")
        cut = int(chunk["location"]) + 6 * int(chunk["N"])
    with open(path, "rb") as src, open(out, "wb") as dst:
        left = cut
        while left:
            buf = src.read(min(left, 1 << 26))
            dst.write(buf)
            left -= len(buf)
    return cut


def phase_sigterm(dev, card, params):
    """Phase 13: the 1M flagship run with its dump, in a child process,
    terminated by SIGTERM once it submitted frame ``SIGTERM_AFTER``: it
    exits with 1, its file verifies deep and holds every frame it
    submitted, each bit-equal to the same step run here; then the port's
    CLI, with torch blocked, on that file.  Returns the child's launches
    a role."""
    tag = "phase 13 (SIGTERM)"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="tpgsd_sigterm_")
    try:
        path = os.path.join(workdir, "terminated.gsd")
        with open(os.path.join(workdir, "child.err"), "w+") as err:
            t_start = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sigterm-child",
                 path, repr(float(params.h))],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=err, text=True)
            watchdog = threading.Timer(SIGTERM_TIMEOUT_S, proc.kill)
            watchdog.start()
            lines, submitted, t_signal, t_first = [], 0, None, None
            try:
                for line in iter(proc.stdout.readline, ""):
                    lines.append(line.rstrip("\n"))
                    if line.startswith("submitted "):
                        submitted = int(line.split()[1])
                        if t_first is None:
                            t_first = time.perf_counter()
                        if submitted == SIGTERM_AFTER and t_signal is None:
                            proc.send_signal(signal.SIGTERM)
                            t_signal = time.perf_counter()
                rc = proc.wait()
                t_exit = time.perf_counter()
            finally:
                watchdog.cancel()
                proc.stdout.close()
            err.seek(0)
            child_err = err.read()
        said = {line.split(":")[0]: int(line.split()[1]) for line in lines
                if line.startswith(("signalled:", "closed:"))}
        if rc != 1 or t_signal is None or "signalled" not in said:
            raise AssertionError("%s: exit code %r, signal %s, output %s\n%s"
                                 % (tag, rc, t_signal is not None, lines[-5:],
                                    child_err[-3000:]))
        report = tpgsd_torch.pypgsd.verify(path, deep=True)
        m = report["frames"]
        if not report["ok"]:
            raise AssertionError("%s: verify: %s" % (tag, report["errors"]))
        # a frame is queued before submit returns, so a signal between the
        # two leaves one frame more than the last line said
        if not (SIGTERM_AFTER <= m and submitted <= m <= submitted + 1
                and said["closed"] == m):
            raise AssertionError(
                "%s: %d frames in the file, %d submitted, the runner closed at "
                "%d" % (tag, m, submitted, said["closed"]))
        child_counts = json.loads(next(
            line for line in lines if line.startswith("launches "))[9:])
        per_step = PATHS["summation"]["per_step"]
        for key, n_per in per_step.items():
            if not n_per * m <= child_counts.get(key, 0) <= n_per * (m + 1):
                raise AssertionError("%s: %s launched %d times in the child's "
                                     "%d steps" % (tag, key,
                                                   child_counts.get(key, 0), m))
        print("%s: the child (the 1M spill summation step, a %.1f MB frame "
              "every step, depth %d) started in %.2f s to its first frame; "
              "SIGTERM after frame %d, it exited with %d %.3f s later; %d "
              "frames submitted, %d in the file, %d written after the signal; "
              "launches %s [%s]"
              % (tag, report["data_bytes"] / m / 1e6, SIGTERM_DEPTH, t_first - t_start, SIGTERM_AFTER, rc,
                 t_exit - t_signal, submitted, m,
                 said["closed"] - said["signalled"],
                 json.dumps({k: v for k, v in child_counts.items() if v}),
                 card))

        # the same run here: every frame bit-equal to its step
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step, state = configuration("spill", N_1M, dev, "summation")
        slength = torch.full((state.x.shape[0],), params.h, device=dev)
        for i in range(m):
            state, (rho, p, _ov) = step(state)
            want = sigterm_frame(state, rho, p, slength)
            got = frame_arrays(path, i)
            if int(got.pop("configuration/step")[0]) != i:
                raise AssertionError("%s: frame %d's step" % (tag, i))
            for name, value in want.items():
                if not np.array_equal(got[name], value.cpu().numpy()):
                    raise AssertionError("%s: frame %d's %s differs from the "
                                         "run here" % (tag, i, name))
        counts = dict(ops.launch_counts)
        for key, value in counts.items():
            if value != per_step.get(key, 0) * m:
                raise AssertionError("%s: %s launched %d times in %d steps "
                                     "here" % (tag, key, value, m))
        print("%s: %d frames, each bit-equal to the same step run here "
              "(position, velocity, density, pressure, slength); "
              "pypgsd.verify(deep=True) ok, %.1f MB [%s]"
              % (tag, m, report["file_size"] / 1e6, card))
        phase_cli(path, m, workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 13 ran %.1f s [%s]" % (time.perf_counter() - t_phase, card))
    return child_counts


def phase_cli(path, m, workdir, card):
    """Phase 13: the port's CLI with torch, JAX and the JAX package
    blocked on the terminated run's file: ``info``, ``dump``, ``verify``
    (intact and truncated inside the last frame's data) and ``convert``
    of frame 0; the host's wall time of each."""
    tag = "phase 13 (CLI)"
    times = {}

    def run(name, args, want_rc):
        """stdout's lines of ``python -m tpgsd_torch ARGS``, blocked."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WRAPPER] + args,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        times[name] = time.perf_counter() - t0
        if proc.returncode != want_rc:
            raise AssertionError("%s: %s exited with %d\n%s\n%s" % (
                tag, name, proc.returncode, proc.stdout[-2000:],
                proc.stderr[-2000:]))
        return proc.stdout.splitlines()

    info = run("info", ["info", path], 0)
    position = [line for line in info if "particles/position" in line]
    if ("frames: %d" % m) not in info or len(position) != 1 or not (
            position[0].endswith("[%d x 3] float32" % N_1M_PARTICLES)):
        raise AssertionError("%s: info said %s" % (tag, info))
    dumped = run("dump", ["dump", path, "-n", "particles/density", "-f", "0"],
                 0)
    if not dumped or not dumped[0].startswith("["):
        raise AssertionError("%s: dump said %s" % (tag, dumped))
    verified = run("verify", ["verify", path], 0)
    if verified[-1] != "OK":
        raise AssertionError("%s: verify said %s" % (tag, verified))
    cut_path = os.path.join(workdir, "truncated.gsd")
    cut = truncated_copy(path, cut_path)
    corrupt = run("verify (truncated)", ["verify", cut_path], 1)
    os.remove(cut_path)
    if not corrupt[-1].startswith("CORRUPT ("):
        raise AssertionError("%s: verify of the cut file said %s"
                             % (tag, corrupt))
    outdir = os.path.join(workdir, "vtu")
    run("convert", ["convert", path, "--frames", "0:1", "-o", outdir], 0)
    written = sorted(os.listdir(outdir))
    if len(written) != 1:
        raise AssertionError("%s: convert wrote %s" % (tag, written))
    with open(os.path.join(outdir, written[0])) as f:
        head = f.read(4096)
    if ('NumberOfPoints="%d"' % N_1M_PARTICLES) not in head:
        raise AssertionError("%s: %s has no NumberOfPoints=\"%d\""
                             % (tag, written[0], N_1M_PARTICLES))
    print("%s: python -m tpgsd_torch with torch, jax and tpgsd blocked: info "
          "(frames: %d, [%d x 3] float32), dump, verify OK, verify of a copy "
          "cut at byte %d (inside the last frame's positions) %s, convert "
          "--frames 0:1 (%s, %.1f MB, NumberOfPoints=\"%d\") [%s]"
          % (tag, m, N_1M_PARTICLES, cut, corrupt[-1], written[0],
             os.path.getsize(os.path.join(outdir, written[0])) / 1e6,
             N_1M_PARTICLES, card))
    print("%s: wall s a subcommand on a %.1f MB file (host clock, the "
          "interpreter's start included): %s [%s]"
          % (tag, os.path.getsize(path) / 1e6,
             ", ".join("%s %.3f" % kv for kv in times.items()), card))


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
    started = time.perf_counter()
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
    phase_registers(_build.library_path().with_suffix(".so.log").read_text())

    db = dam_break(n_side=N_1M, capacity="auto", capacity_headroom=1.15,
                   device=dev)
    print("1M dam break: N=%d, grid %s, K=%d" % (
        db.n, "x".join(map(str, db.grid.dims)), db.grid.capacity))
    params = db.params
    errs, inputs = phase_kernels_vs_plain(db, dev)
    del db
    errs_wide, tier_wide, plain_ms_wide = phase_wide_kernels_vs_plain(dev, card)
    errs.update(errs_wide)
    counts = {path: phase_main_path(dev, card, params, path) for path in PATHS}
    counts.update(phase_energy_rate(dev, card)[0])
    phase_rows(dev, card)
    phase_periodic(dev, card)
    steps100 = {mode: phase_kernel_vs_plain_step(dev, mode)
                for mode in PATHS_MODES}
    for mode in PATHS_MODES:
        phase_kernel_vs_plain_step(dev, mode, "wide")
        phase_kernel_vs_plain_step(dev, mode, "periodic spill", N_BOX_64K)
    phase_kernel_vs_plain_step(dev, "summation", "periodic wide", N_BOX_64K)
    for mode in PATHS_MODES:
        for layout, n_side in (("spill", N_100K), ("wide", N_100K),
                               ("periodic spill", N_BOX_64K)):
            phase_kernel_vs_plain_step(dev, mode, layout, n_side, OPTIONS)
    times = phase_times(dev, card, params, steps100, inputs[24], inputs[32],
                        {"tier": tier_wide, "plain_ms": plain_ms_wide})
    del steps100, inputs, tier_wide
    for layout, mode in (("spill", "summation"), ("spill", "continuity"),
                         ("wide", "summation"), ("wide", "continuity")):
        phase_profile(dev, card, layout, N_1M, mode)
    for mode in PATHS_MODES:
        phase_profile(dev, card, "spill", N_1M, mode, options=OPTIONS)
    t8 = time.perf_counter()
    phase_adaptive_vs_fixed(dev, card, params)
    for mode in PATHS_MODES:
        phase_rollout(dev, card, params, mode)
    phase_lattice(dev, card)
    print("phase 8 ran %.1f s" % (time.perf_counter() - t8))
    t9 = time.perf_counter()
    phase_slab_kernels_vs_plain(dev, card)
    phase_slab_vs_global(dev, card)
    phase_global_peak(dev, card)
    slab_counts = phase_cycle_1e8(dev, card)
    print("phase 9 ran %.1f s [%s]" % (time.perf_counter() - t9, card))
    t10 = time.perf_counter()
    decomp_counts, decomp_paths, decomp_ms = phase_decomposition(dev, card)
    # the energy pass's cross role runs on the decomposed step alone
    counts["decomposed options summation"] = decomp_paths[
        "decomposed options summation"]
    for path, (ms_d, ms_g) in decomp_ms.items():
        print("phase 10 (1M %s): %d shards on one device %.4f ms/step, the "
              "global step %.4f ms/step (ratio %.3f; the decomposition's "
              "overhead, not scaling) [%s]"
              % (path, DECOMP_SHARDS, ms_d, ms_g, ms_d / ms_g, card))
    print("phase 10 ran %.1f s [%s]" % (time.perf_counter() - t10, card))
    t11 = time.perf_counter()
    block_counts, _block_ms = phase_blocks(dev, card)
    print("phase 11 ran %.1f s [%s]" % (time.perf_counter() - t11, card))
    mp_counts, _mp_times = phase_processes(dev, card)
    sigterm_counts = phase_sigterm(dev, card, params)
    check_no_reference_modules()
    print("no jax, jaxlib or tpgsd module was imported")
    print("chip_smoke.py ran %.1f s (wall, the kernels' build included)"
          % (time.perf_counter() - started))

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": counts[path][key],
            # the same role's launches in the 1e8 cycle's silent steps
            "slab_launches": slab_counts.get(key, 0),
            # and in one decomposed 1M step (2 shards)
            "decomp_launches": decomp_counts.get(key, 0),
            # and in one 1M step of the (2, 2) and (2, 2, 2) block forms
            "decomp2d_launches": block_counts["2d"].get(key, 0),
            "decomp3d_launches": block_counts["3d"].get(key, 0),
            # and in one 1M step of each form over processes, summed over
            # the processes (phase 12)
            "mp_launches": {form: mp_counts[form].get(key, 0)
                            for form in mp_counts},
            # and in phase 13's terminated run of the 1M step (the child)
            "sigterm_launches": sigterm_counts.get(key, 0),
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
    kernels.append(row_kernel_entry(counts, slab_counts))
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
    if sys.argv[1:2] == ["--sigterm-child"]:
        sigterm_child(sys.argv[2], float(sys.argv[3]))
    else:
        main()
