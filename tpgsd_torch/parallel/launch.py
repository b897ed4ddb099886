"""One OS process per rank on one host: the group's start and the
spawning of worker processes with a deadline.

:func:`init_process_group` starts ``torch.distributed`` in a worker (TCP
rendezvous on ``localhost``, an explicit rank and world size: nothing on
the machine tells a program of a cluster) and returns its
:class:`~tpgsd_torch.parallel.comm.TorchProcessComm`.  :func:`spawn` starts
``python -m tpgsd_torch.parallel.worker`` once a rank and waits for all of
them under one deadline; when a worker fails or the deadline passes, every
worker still running is killed, so a hang fails one caller instead of
stalling it.
"""

import os
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

#: seconds a collective may wait before the group gives up
GROUP_TIMEOUT_S = 60


def free_port():
    """A TCP port on ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(rank, size, port, backend="gloo",
                       timeout_s=GROUP_TIMEOUT_S):
    """Start the default ``torch.distributed`` group of this process (rank
    ``rank`` of ``size``, rendezvous at ``tcp://localhost:port``) and
    return its :class:`~tpgsd_torch.parallel.comm.TorchProcessComm`."""
    import torch.distributed as dist

    from .comm import TorchProcessComm

    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method="tcp://localhost:%d" % int(port),
        rank=int(rank), world_size=int(size), timeout=timeout,
    )
    return TorchProcessComm(timeout=timeout)


class Finished:
    """The outcome of :func:`spawn`: ``returncodes`` (a killed worker's is
    negative), ``outputs`` (each worker's merged stdout and stderr) and
    ``timed_out``."""

    def __init__(self, returncodes, outputs, timed_out):
        self.returncodes = returncodes
        self.outputs = outputs
        self.timed_out = timed_out

    def check(self):
        """Raise with the failing workers' output tails unless every
        worker exited 0 within the deadline."""
        bad = [r for r, rc in enumerate(self.returncodes) if rc != 0]
        if bad or self.timed_out:
            tails = "\n".join("--- rank %d (exit %s) ---\n%s"
                              % (r, self.returncodes[r],
                                 self.outputs[r][-3000:]) for r in bad)
            raise RuntimeError("workers failed%s: ranks %s\n%s" % (
                " (deadline passed)" if self.timed_out else "", bad, tails))
        return self


def spawn(workdir, nprocs, timeout_s):
    """Run ``python -m tpgsd_torch.parallel.worker workdir rank nprocs
    port`` for every rank, each in a process of its own, and wait for all
    of them, at most ``timeout_s`` seconds in all.

    A worker that exits non-zero, or the deadline, kills every worker
    still running.  Each worker's output goes to
    ``workdir/rank<r>.log``.  Returns :class:`Finished`.
    """
    workdir = Path(workdir)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    port = str(free_port())
    logs = [open(workdir / ("rank%d.log" % r), "w") for r in range(nprocs)]
    procs = []
    try:
        for r in range(nprocs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpgsd_torch.parallel.worker",
                 str(workdir), str(r), str(nprocs), port],
                stdout=logs[r], stderr=subprocess.STDOUT, env=env,
                start_new_session=True,
            ))
        deadline = time.monotonic() + timeout_s
        timed_out = False
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                timed_out = time.monotonic() > deadline
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    outputs = [(workdir / ("rank%d.log" % r)).read_text()
               for r in range(nprocs)]
    return Finished([p.returncode for p in procs], outputs, timed_out)
