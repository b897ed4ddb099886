"""The worker of one rank, and the runs it drives:

    python -m tpgsd_torch.parallel.worker WORKDIR RANK SIZE PORT

(:func:`tpgsd_torch.parallel.launch.spawn` starts one a rank).  The
worker starts the group (``WORKDIR/case.pkl`` names the backend, Gloo by
default), runs each of the case's runs in order, holds its results to
what the parent wrote for it, writes ``WORKDIR/out<RANK>.pkl`` and exits
0; any failure raises, and the worker exits non-zero.  It imports
``tpgsd_torch``, numpy and torch only, and checks at its end that
neither ``jax`` nor the JAX package ``tpgsd`` was loaded.

A run is a dict with ``"kind"``:

* ``"step"`` (:func:`drive`): a decomposed SPH step (``"form"``: slab,
  2d or 3d) over a mesh of this process's ``"devices"``, ``"steps"``
  steps from the global ``"state"`` (numpy ``(x, v, rho)``), optionally
  adaptive, writing frames, counting the first step's launches and
  timing steps.  The parent runs the same dict with ``comm=None`` on a
  one-process mesh of every shard (the single-controller step), and
  :func:`hold` checks each worker's shards bit for bit against it.
* ``"striped"``, ``"composed"``, ``"kill"`` and ``"pod_io"``: the file
  layer over the processes (striped writes of uneven stripes, the
  compose-on-commit writer, the controller killed mid-frame, and several
  shards a process written and read back).
"""

import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import exchange


def _forms():
    from ..sph import (
        distribute_state,
        distribute_state_2d,
        distribute_state_3d,
        make_adaptive_distributed2d_step_fn,
        make_adaptive_distributed3d_step_fn,
        make_adaptive_distributed_step_fn,
        make_distributed2d_step_fn,
        make_distributed3d_step_fn,
        make_distributed_step_fn,
    )
    from .mesh import make_mesh, make_mesh2d, make_mesh3d

    return {
        "slab": (lambda shape, devices, comm: make_mesh(devices=devices,
                                                        comm=comm),
                 distribute_state, make_distributed_step_fn,
                 make_adaptive_distributed_step_fn),
        "2d": (lambda shape, devices, comm: make_mesh2d(
            shape=shape, devices=devices, comm=comm), distribute_state_2d,
            make_distributed2d_step_fn, make_adaptive_distributed2d_step_fn),
        "3d": (lambda shape, devices, comm: make_mesh3d(
            shape=shape, devices=devices, comm=comm), distribute_state_3d,
            make_distributed3d_step_fn, make_adaptive_distributed3d_step_fn),
    }


def _sync(devices):
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _snapshot(dist):
    """This process's shards of ``dist`` as numpy arrays, one dict a
    shard."""
    out = []
    for i in range(len(dist.x)):
        shard = {"x": dist.x[i], "v": dist.v[i], "pid": dist.pid[i]}
        if dist.rho is not None:
            shard["rho"] = dist.rho[i]
        out.append({k: t.cpu().numpy() for k, t in shard.items()})
    return out


def _writers(run, comm):
    from .comm import SingleComm
    from .compose_io import ComposedFrameWriter
    from .shard_io import ShardedFrameWriter

    comm = SingleComm() if comm is None else comm
    made = []
    for kind, path in run.get("write", {}).items():
        cls = ShardedFrameWriter if kind == "sharded" else ComposedFrameWriter
        made.append(cls(path, application="tpgsd_torch.parallel",
                        comm=comm))
    return made


def drive(run, comm=None, devices=None):
    """Drive one ``"step"`` run; returns a dict of its results.

    ``devices`` are this process's (default ``run["devices"]``); with
    ``comm=None`` they are every shard's and one process drives the mesh.
    The result holds ``"mesh"`` (the local shard ids), ``"capacity"``,
    ``"history"`` (per held step, :func:`_snapshot` of the state),
    ``"dts"`` (adaptive: each ``dt_next`` as float32 bits), ``"overflow"``
    (this process's cell and migration overflow after the last step),
    ``"launches"`` (the kernels' launches in the first step, when
    ``run["count"]``), ``"pids"`` (this process's live pids after the
    last step, sorted, when ``run["census"]``), ``"collected"`` (the
    final state in pid order, gathered over ``comm``, when
    ``run["collect"]``) and ``"timed"``
    (``(seconds, steps, host syncs, bytes sent to other processes, and
    the exchanges' sync and other seconds)`` of ``run["time"]`` more
    steps; :data:`~.exchange.stats`).
    """
    from ..sph import ops
    from ..sph.distributed import collect_state, frame_shards
    from ..sph.step import SPHState

    make_mesh, distribute, build, build_adaptive = _forms()[run["form"]]
    devices = run["devices"] if devices is None else devices
    mesh = make_mesh(run.get("shape"), devices, comm)
    x, v, rho = run["state"]
    dist, cap = distribute(SPHState(x=x, v=v, rho=rho), run["grid"], mesh)
    adaptive = run.get("adaptive", False)
    step = (build_adaptive if adaptive else build)(
        run["grid"], run["params"], mesh, capacity=cap, **run.get("kw", {}))
    dt = torch.tensor(run["params"].dt, dtype=torch.float32,
                      device=mesh.devices[mesh.local[0]])
    held = set(run.get("hold", range(run["steps"])))
    writers = _writers(run, comm)
    res = {"mesh": mesh.local, "capacity": cap, "history": {}, "dts": [],
           "launches": None}
    for i in range(run["steps"]):
        counting = i == 0 and run.get("count", False)
        if counting:
            _sync(devices)
            ops.reset_launch_counts()
        if adaptive:
            dist, aux, dt = step(dist, dt)
            res["dts"].append(dt.cpu().numpy().view(np.uint32).item())
        else:
            dist, aux = step(dist)
        if counting:
            _sync(devices)
            res["launches"] = {k: n for k, n in ops.launch_counts.items()
                               if n}
        if i in held:
            res["history"][i] = _snapshot(dist)
        if i < run.get("frames", 0):
            for w in writers:
                w.write_frame({
                    "particles/position": frame_shards(dist.x, mesh),
                    "particles/velocity": frame_shards(dist.v, mesh),
                    "log/pid": frame_shards(dist.pid, mesh)}, step=i)
    for w in writers:
        w.close()
    res["overflow"] = (int(sum(int(c) for c in aux.cell_overflow)),
                       int(sum(int(m) for m in aux.migrate_overflow)))
    if run.get("census", False):
        res["pids"] = np.sort(np.concatenate(
            [p[p >= 0].cpu().numpy() for p in dist.pid]))
    if run.get("collect", False):
        res["collected"] = collect_state(dist, len(x), comm)
    if run.get("time", 0):
        res["timed"] = _time(step, dist, dt if adaptive else None,
                             run["time"], devices, comm)
    return res


def _time(step, dist, dt, n, devices, comm):
    """``(seconds, n, host syncs, bytes sent, sync seconds, exchange
    seconds)`` of ``n`` more steps, host clock from a barrier to the last
    step's end on every process."""
    for _ in range(2):  # warm-up
        dist = step(dist, dt)[0] if dt is not None else step(dist)[0]
    _sync(devices)
    if comm is not None:
        comm.barrier()
    exchange.reset_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        if dt is not None:
            dist, _aux, dt = step(dist, dt)
        else:
            dist, _aux = step(dist)
    _sync(devices)
    if comm is not None:
        comm.barrier()
    return (time.perf_counter() - t0, n, exchange.stats["host_syncs"],
            exchange.stats["bytes"], exchange.stats["sync_seconds"],
            exchange.stats["seconds"])


def expected_path(workdir, run_index, shard):
    return Path(workdir) / ("expect_%d_%d.pkl" % (run_index, shard))


def save_expected(workdir, run_index, single):
    """Write the single-controller result ``single`` (:func:`drive` with
    ``comm=None``) of run ``run_index``, one file a shard, for
    :func:`hold` in the workers."""
    for d in single["mesh"]:
        shard = {i: snap[d] for i, snap in single["history"].items()}
        with open(expected_path(workdir, run_index, d), "wb") as f:
            pickle.dump({"history": shard, "dts": single["dts"]}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)


def hold(res, workdir, run_index):
    """Hold this process's shards, at every held step, and its dts bit
    for bit to the single-controller run's; raises on a difference."""
    for j, d in enumerate(res["mesh"]):
        with open(expected_path(workdir, run_index, d), "rb") as f:
            want = pickle.load(f)
        if res["dts"] != want["dts"]:
            raise AssertionError("run %d: dts %s, single controller %s"
                                 % (run_index, res["dts"], want["dts"]))
        for i, snap in res["history"].items():
            for key, arr in snap[j].items():
                ref = want["history"][i][key]
                if arr.shape != ref.shape or arr.tobytes() != ref.tobytes():
                    raise AssertionError(
                        "run %d, step %d, shard %d: %s differs from the "
                        "single-controller step's" % (run_index, i, d, key))


def write_case(workdir, runs, backend="gloo"):
    """Write ``WORKDIR/case.pkl``: the ``runs`` every worker runs, in
    order, and the group's backend."""
    with open(Path(workdir) / "case.pkl", "wb") as f:
        pickle.dump({"runs": runs, "backend": backend}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def over_processes(workdir, runs, nprocs, timeout_s, backend="gloo"):
    """The parent's side of a case: drive each ``"step"`` run on one
    process over every shard (the single-controller step, its writers on
    ``<path>.one``) and write what the workers hold against, then spawn
    ``nprocs`` workers on ``runs`` (:func:`~.launch.spawn`) and wait for
    them; a failed worker raises.  Returns ``(singles, results)``: the
    single-controller result of each run (``None`` for a file run) and
    each rank's list of results."""
    from .launch import spawn

    workdir = Path(workdir)
    singles = []
    for j, run in enumerate(runs):
        single = None
        if run["kind"] == "step":
            alone = dict(run, write={kind: path + ".one" for kind, path
                                     in run.get("write", {}).items()})
            single = drive(alone, None, devices=list(run["devices"]) * nprocs)
            save_expected(workdir, j, single)
            del single["history"]
        singles.append(single)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    write_case(workdir, runs, backend)
    spawn(workdir, nprocs, timeout_s).check()
    results = []
    for r in range(nprocs):
        with open(workdir / ("out%d.pkl" % r), "rb") as f:
            results.append(pickle.load(f))
    return singles, results


# --------------------------------------------------------------------------
# the file layer over the processes
# --------------------------------------------------------------------------


def striped(run, comm):
    """Uneven stripes (rank r owns 3 + r rows) of ``d`` and a rank-0
    ``step`` scalar, 2 frames, read back in the session on every rank."""
    from .. import fl

    counts = np.array([3 + r for r in range(comm.size)], dtype=np.uint64)
    lo = int(counts[:comm.rank].sum())
    data = np.arange(int(counts.sum()), dtype=np.float64)
    f = fl.PGSDFile(run["path"], "w", application="mp", schema="none",
                    schema_version=(1, 0), comm=comm)
    for frame in range(2):
        f.write_chunk("step", np.array([frame], np.uint64), write_all=False)
        f.write_chunk("d", data[lo:lo + int(counts[comm.rank])] + frame,
                      offset=counts, rank=comm.rank, write_all=True)
        f.end_frame()
    if not (f.chunk_exists(0, "d")
            and np.array_equal(f.read_chunk(1, "d"), data + 1)):
        raise AssertionError("in-session read of the striped chunk")
    f.close()


def log_frames(rank, size, rows, frames):
    """Frame ``i``'s rows of ``log/d`` that process ``rank`` owns: its
    ``rows`` rows of ``(arange(rows * size) * 10 + i)``, from row ``rank
    * rows``."""
    local = (np.arange(rows, dtype=np.float64) + rows * rank) * 10
    return [local + i for i in range(frames)]


def composed(run, comm):
    """The compose-on-commit writer over the processes: each writes its
    own rows of ``log/d`` as :class:`~.shard_io.ProcessShards`, 3
    frames."""
    from .compose_io import ComposedFrameWriter
    from .shard_io import ProcessShards

    rows = run["rows"]
    w = ComposedFrameWriter(run["path"], schema="none", schema_version=(1, 0),
                            comm=comm)
    for i, local in enumerate(log_frames(comm.rank, comm.size, rows, 3)):
        w.write_frame({"log/d": ProcessShards(
            starts=(rows * comm.rank,), tensors=(torch.from_numpy(local),),
            shape=(rows * comm.size,))}, step=i)
    w.close()


def kill(run, comm):
    """Three committed frames of striped ``d``; frame 3's bytes written,
    then the controller (rank 0) kills itself before any index commit and
    the others leave without flushing."""
    from .. import fl

    counts = np.array([4] * comm.size, dtype=np.uint64)
    lo = 4 * comm.rank
    data = np.arange(4 * comm.size, dtype=np.float64)
    f = fl.PGSDFile(run["path"], "w", application="mp", schema="none",
                    schema_version=(1, 0), comm=comm)
    for frame in range(3):
        f.write_chunk("d", data[lo:lo + 4] + frame, offset=counts,
                      rank=comm.rank, write_all=True)
        f.end_frame()
    f.flush()
    f.write_chunk("d", data[lo:lo + 4] + 99.0, offset=counts,
                  rank=comm.rank, write_all=True)
    comm.barrier()  # every rank's frame-3 bytes are written
    if comm.rank == 0:
        os.kill(os.getpid(), 9)
    time.sleep(1.0)
    os._exit(0)


def pod_io(run, comm):
    """Several shards a process (``run["devices"]``, ``rows`` rows each)
    of ``log/d`` through :class:`~.shard_io.ShardedFrameWriter`, 2
    frames, read in the session, then read back shard by shard with
    :func:`~.shard_io.read_sharded_chunk` into the same layout."""
    from .. import fl
    from .shard_io import ProcessShards, ShardedFrameWriter, read_sharded_chunk

    rows, devices = run["rows"], run["devices"]
    total = rows * len(devices) * comm.size
    data = np.arange(total * 2, dtype=np.float64).reshape(total, 2)
    first = comm.rank * len(devices)
    starts = tuple((first + j) * rows for j in range(len(devices)))

    def shards(frame):
        return ProcessShards(starts=starts, tensors=tuple(
            torch.from_numpy(data[s:s + rows] + frame).to(dev)
            for s, dev in zip(starts, devices)), shape=(total, 2))

    w = ShardedFrameWriter(run["path"], schema="none", schema_version=(1, 0),
                           comm=comm)
    for frame in range(2):
        w.write_frame({"log/d": shards(float(frame))}, step=frame)
    if not np.array_equal(w.file.read_chunk(1, "log/d"), data + 1.0):
        raise AssertionError("in-session read of the pod file")
    w.close()
    with fl.open(run["path"], "r") as f:
        back = read_sharded_chunk(f, 0, "log/d", like=shards(0.0))
    for s, t in zip(back.starts, back.tensors):
        if not np.array_equal(t.cpu().numpy(), data[s:s + rows]):
            raise AssertionError("read-back of the shard at row %d" % s)
    if back.shape != (total, 2) or back.starts != starts:
        raise AssertionError("read-back layout %s" % (back,))


_FILE_RUNS = {"striped": striped, "composed": composed, "kill": kill,
              "pod_io": pod_io}


def main(argv):
    workdir, rank, size, port = Path(argv[0]), int(argv[1]), int(argv[2]), \
        int(argv[3])
    with open(workdir / "case.pkl", "rb") as f:
        case = pickle.load(f)
    torch.set_num_threads(1)  # several workers share the host's cores
    from .launch import init_process_group

    comm = init_process_group(rank, size, port,
                              backend=case.get("backend", "gloo"))
    results = []
    for j, run in enumerate(case["runs"]):
        if run["kind"] != "step":
            results.append(_FILE_RUNS[run["kind"]](run, comm))
            continue
        res = drive(run, comm)
        hold(res, workdir, j)
        del res["history"]  # held: the parent needs the rest
        results.append(res)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                            "tpgsd")]
    if loaded:
        raise AssertionError("the worker imported %s" % loaded[:8])
    with open(workdir / ("out%d.pkl" % rank), "wb") as f:
        pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
    comm.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()
    print("rank %d of %d OK" % (rank, size), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
