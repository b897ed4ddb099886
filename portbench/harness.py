"""One run of one cell: set-up, the measured window, the checks.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (sizes, physics, the policy and launches the
step must resolve to, the system that builds it, the reference that
judges it and the limits), ``traffic/<traffic>.json`` (the dump cadence
and the frame's chunks), ``metrics/<metric>.py`` (a reader of the traced
stretch), ``systems/<system>.py`` (how the program's step is built) and
``reference/<reference>.py`` (the plain step it is held to).
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import compare, counts, framesum, inputs, profile, reference
from .gsd_read import GSDFile
from .metrics import load as load_metric

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tpgsd")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``tpgsd_torch`` is not ``tpgsd``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell(NamedTuple):
    name: str
    cfg: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / (w["traffic"] + ".json"))
                         .read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, cfg, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def power_limit():
    """The card's power limit as nvidia-smi reads it (``"700.00 W"``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """A mark on the device's stream after each step (a CUDA event, read
    only after the window; the host clock on the CPU)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class TimedWriter:
    """The program's frame writer, with the host clock read when each
    ``write_frame`` returns (``done[step]``)."""

    def __init__(self, inner):
        self.inner = inner
        self.done = {}

    def write_frame(self, chunks, step=None):
        self.inner.write_frame(chunks, step=step)
        self.done[step] = time.perf_counter()

    def flush(self):
        self.inner.flush()

    def close(self):
        self.inner.close()


class Run:
    """The program's state as the run drives it, step by step."""

    def __init__(self, cell, prog, device, workdir):
        self.cell, self.prog, self.device = cell, prog, device
        self.every = int(cell.traffic.get("dump_every", 0))
        self.i = 0  # steps taken from the seed's state
        self.prev = self.state = self.aux = None
        self.overflows = []
        self.clock = StepClock(device)
        self.submitted = {}  # step -> host clock at the start of submit
        self.sums = {}  # step -> {chunk: framesum.device_sums}
        self.dump = self.writer = self.path = None
        if self.every:
            from tpgsd_torch.io_runtime import AsyncDumpRunner
            from tpgsd_torch.parallel import ShardedFrameWriter, SingleComm

            sc = cell.cfg["scenario"]
            box = np.array(list(sc["box"]) + [0.0, 0.0, 0.0], np.float32)
            self.path = os.path.join(workdir, "trajectory.gsd")
            self.writer = TimedWriter(ShardedFrameWriter(
                self.path, application="portbench", comm=SingleComm(),
                static={"configuration/box": box}))
            self.dump = AsyncDumpRunner(self.writer,
                                        depth=cell.traffic["depth"])
            self.slength = torch.full((prog.n,), cell.cfg["physics"]["h"],
                                      dtype=torch.float32, device=device)

    def frame(self):
        """The chunks of a frame of the state, named as the traffic mix
        names them (``{chunk: field}``)."""
        rho, p = self.aux[0], self.aux[1]
        fields = {"position": self.state.x, "velocity": self.state.v,
                  "density": rho, "pressure": p, "slength": self.slength}
        return {name: fields[field]
                for name, field in self.cell.traffic["chunks"].items()}

    def emit(self, traced=False):
        """Submit a frame of the state, and take its sums on the device
        behind it."""
        with profile.span("portbench.submit", traced):
            chunks = self.frame()
            self.submitted[self.i] = time.perf_counter()
            self.dump.submit(chunks, step=self.i)
            self.sums[self.i] = {k: framesum.device_sums(t)
                                 for k, t in chunks.items()}

    def advance(self, traced=False, emit=True):
        self.prev = self.state
        with profile.span("portbench.step", traced):
            self.state, self.aux = self.prog.step(self.state)
        self.i += 1
        self.overflows.extend(self.aux[2:])
        if emit and self.every and self.i % self.every == 0:
            self.emit(traced)
        self.clock.mark()

    def window(self, seconds=None, steps=None, traced=False, drain=True):
        """Steps until ``seconds`` have passed (then on to the next
        emitting step) or ``steps`` steps; ends when the device is done
        and, with ``drain``, every submitted frame is on disk.  Returns
        ``(steps, s)``."""
        sync(self.device)
        first = self.i
        t0 = time.perf_counter()
        self.clock.mark()
        while True:
            self.advance(traced)
            n = self.i - first
            if steps is not None:
                if n >= steps:
                    break
            elif (time.perf_counter() - t0 >= seconds
                  and (not self.every or self.i % self.every == 0)):
                break
        with profile.span("portbench.window_end", traced):
            sync(self.device)
        if drain and self.dump is not None:
            self.dump.flush()
        return n, time.perf_counter() - t0


def rows_of(state, aux, rows):
    """The rows the checks read of a step's output."""
    return {"x": state.x[rows], "v": state.v[rows], "rho": aux[0][rows]}


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def check_program(prog, cfg, launches, steps):
    """The policy and the pair-kernel launches the configuration states
    (``resolved``, ``launches_per_step``), or raise: a run on the plain
    passes is never timed as the kernels."""
    if prog.resolved != cfg["resolved"]:
        raise RuntimeError("step resolved to %r, not %r"
                           % (prog.resolved, cfg["resolved"]))
    expect = {k: v * steps for k, v in cfg["launches_per_step"].items()}
    if launches != expect:
        raise RuntimeError("pair-kernel launches %r over %d steps, not %r"
                           % (launches, steps, expect))


def check_frames(run, window_frames, final_rows):
    """Frames of the window missing from the file, mis-shaped, or whose
    sums differ from those taken on the device at their step; and the
    last frame against the final state bit for bit ->
    ``(frames_bad, lines)``."""
    bad, lines = 0, []
    names = list(final_rows)
    with GSDFile(run.path) as f:
        lines.append("file: %d frames, %d bytes" % (f.frames,
                                                    os.path.getsize(run.path)))
        in_file = {}
        for k in range(f.frames):
            try:
                in_file[int(f.read(k, "configuration/step")[0])] = k
            except KeyError:
                pass
        for step in window_frames:
            k = in_file.get(step)
            ok = k is not None
            for name in names if ok else ():
                try:
                    n, m, dt = f.shape(k, name)
                except KeyError:
                    ok = False
                    break
                want = final_rows[name]
                ok = ok and (n, m, dt) == (len(want), want[0].size,
                                           want.dtype)
                ok = ok and framesum.equal(
                    framesum.host_sums(f.read(k, name)),
                    framesum.as_host(run.sums[step][name]))
            bad += not ok
        lines.append("frames of the window: %d, in the file with the sums "
                     "taken at their step: %d" % (len(window_frames),
                                                  len(window_frames) - bad))
        if window_frames:
            step = window_frames[-1]
            k = in_file.get(step)
            same = k is not None and all(
                np.array_equal(f.read(k, name).reshape(final_rows[name].shape),
                               final_rows[name]) for name in names)
            lines.append("last frame (step %d): %s" % (
                step, "equal bit for bit" if same else "DIFFERS"))
            bad += not same
    return bad, lines


def reference_gaps(cfg, x, v, got, rows, dtype=torch.float64):
    """:func:`compare.row_gaps` of the program's rows ``got`` against the
    configuration's reference's step from ``(x, v)`` (``dtype``: its
    precision)."""
    ref = reference.load(cfg["reference"])
    want = ref.step_rows(x, v, rows, ref.Params(cfg), dtype)
    return compare.row_gaps(got, want, cfg)


def control_rows(cfg, x, v, rows):
    """The control: the reference's step in bfloat16, put in the
    program's place (its float32 rows)."""
    ref = reference.load(cfg["reference"])
    out = ref.step_rows(x, v, rows, ref.Params(cfg), torch.bfloat16)
    return {"x": out["x"].float(), "v": out["v"].float(),
            "rho": out["rho"].float()}


def run_cell(cell, seed, seconds, trace, device, t_start, log=None,
             fault=None, control=False, marks=None):
    """One run of ``cell``.  Returns ``(result, checks)``: the result
    line's object (``checks`` last) and ``[(name, value, limit)]``.

    ``fault`` (tests only) breaks the timed path: ``fault["step"](step)``
    returns the step the window drives, ``fault["writer"](writer)`` the
    frame writer.  ``control`` (``calibrate.py``) also reads the
    control's gaps on the same two steps into ``result["control"]``.
    ``marks`` (``[(name, host clock)]``) splits the set-up before it."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cfg = cell.cfg
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell, cfg, seed, seconds, trace, device, t_start, log,
                    fault or {}, control, list(marks or []), workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, cfg, seed, seconds, trace, device, t_start, log, fault,
         control, marks, workdir):
    marks.append(("the harness", time.perf_counter()))
    system = importlib.import_module("portbench.systems." + cfg["system"])
    prog = system.build(cfg, device)
    marks.append(("the program's step", time.perf_counter()))
    if prog.n != cfg["n"]:
        raise RuntimeError("the program made %d particles, the "
                           "configuration states %d" % (prog.n, cfg["n"]))
    if "step" in fault:
        prog = prog._replace(step=fault["step"](prog.step))
    x0, v0 = inputs.lattice(cfg, seed, device)
    rows = inputs.sample_rows(prog.n, cfg["check_rows"], seed, device)
    marks.append(("inputs", time.perf_counter()))
    run = Run(cell, prog, device, workdir)
    if "writer" in fault and run.every:
        run.writer.inner = fault["writer"](run.writer.inner)
    run.state = prog.state(x0, v0)
    del x0, v0
    # warm-up: the cell's own shapes, two steps (and one frame)
    run.advance(emit=False)
    first = {k: t.cpu() for k, t in rows_of(run.state, run.aux,
                                             rows).items()}
    start_overflow = [int(o) for o in run.aux[2:]]
    run.advance(emit=False)
    if run.every:
        run.emit()
        run.dump.flush()
    sync(device)
    prog.reset_launches()
    run.overflows = []
    run.clock = StepClock(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))
    log("set-up %.3f s: %s" % (setup_s, ", ".join(
        "%s %.3f" % (name, t - t_prev) for (name, t), t_prev in
        zip(marks, [t_start] + [t for _, t in marks]))))
    window_first = run.i
    n_win, win_s = run.window(seconds=seconds)
    intervals = run.clock.intervals_ms()
    window_frames = sorted(s for s in run.submitted if s > window_first)
    frame_ms = [(run.writer.done[s] - run.submitted[s]) * 1e3
                for s in window_frames] if run.every else []
    rec = None
    if trace:
        frames_before = len(run.submitted)
        steps = max(int(cfg["trace_steps"]), 2 * run.every)
        # the region ends at the device's sync, before the frames drain
        with profile.traced(device) as rec:
            n_tr, _ = run.window(steps=steps, traced=True, drain=False)
        if run.every:
            run.dump.flush()
        rec.update(steps=n_tr, frames=len(run.submitted) - frames_before,
                   n=prog.n, dump_stats=run.dump.stats if run.every else None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    steps_total = run.i - window_first
    launches = prog.launches()
    dropped = sum(int(o) for o in run.overflows) + sum(start_overflow)
    check_program(prog, cfg, launches, steps_total)
    log("asserted: step.resolved %s; pair-kernel launches %s over %d "
        "steps; dropped particles %d"
        % (json.dumps(prog.resolved), json.dumps(launches), steps_total,
           dropped))
    all_frames = sorted(s for s in run.submitted if s > window_first)

    # the checks, once the window has closed and the peak has been read
    last = rows_of(run.state, run.aux, rows)
    final_rows = None
    if run.every:
        final_rows = {k: t.cpu().numpy() for k, t in run.frame().items()}
        run.dump.close()
    if trace:
        rec["work"] = counts.work_per_step(run.prev.x, cfg, seed)
    prev = run.prev
    run.state = run.aux = run.prev = run.prog = prog = None
    limits = cfg["limits"]
    t_ref = time.perf_counter()
    gaps_last, rows_last, amb_last = reference_gaps(cfg, prev.x, prev.v,
                                                    last, rows)
    ctrl = {}
    if control:
        ctrl["last"] = reference_gaps(
            cfg, prev.x, prev.v, control_rows(cfg, prev.x, prev.v, rows),
            rows)[0]
    del prev
    x0, v0 = inputs.lattice(cfg, seed, device)
    gaps_first, rows_first, amb_first = reference_gaps(
        cfg, x0, v0, {k: t.to(device) for k, t in first.items()}, rows)
    if control:
        ctrl["first"] = reference_gaps(
            cfg, x0, v0, control_rows(cfg, x0, v0, rows), rows)[0]
    del x0, v0
    ref_s = time.perf_counter() - t_ref
    failed = (compare.rows_failed(rows_last, limits)
              + compare.rows_failed(rows_first, limits))
    attempted = 2 * rows.numel() + len(all_frames)
    log("reference: %d rows of the first and the last step, %.3f s; "
        "components by a wall judged by the reference's other outcome: %d "
        "and %d; gaps first %s, last %s"
        % (rows.numel(), ref_s, amb_first, amb_last, json.dumps(gaps_first),
           json.dumps(gaps_last)))
    checks = [(k, compare.wider(gaps_first[k], gaps_last[k]), limits[k])
              for k in gaps_first]
    checks.append(("dropped", dropped, limits["dropped"]))
    if run.every:
        frames_bad, lines = check_frames(run, all_frames, final_rows)
        for line in lines:
            log(line)
        log("bytes written: %d" % (os.path.getsize(run.path)))
        failed += frames_bad
        checks.append(("frames_bad", frames_bad, limits["frames_bad"]))
    correct = all(compare.within(v, lim) for _, v, lim in checks)

    metrics = {}
    if not trace:
        values = {
            "ms_per_step": win_s * 1e3 / n_win,
            "step_ms_p99": percentile(intervals, 99) if intervals else None,
            "frame_ms_p90": percentile(frame_ms, 90) if frame_ms else None,
            "peak_bytes_per_particle": peak / cfg["n"] if peak else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        log("window: %d steps in %.6f s, %d frames" % (n_win, win_s,
                                                       len(window_frames)))
    else:
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = profile.union_us([(s, e) for _, s, e in
                                          rec["ops"]]) / 1e6
        dev["window_s"] = (rec["end"] - rec["start"]) / 1e6
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = profile.breakdown(rec)
    if control:
        result["control"] = ctrl
        result["gaps"] = {"first": gaps_first, "last": gaps_last}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks
