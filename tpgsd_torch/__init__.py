"""tpgsd_torch - the PyTorch/CUDA port of tpgsd's SPH producer.

* ``tpgsd_torch.sph`` - WCSPH step on torch tensors; on an NVIDIA Hopper
  card its pair passes run as hand-written CUDA kernels
  (``tpgsd_torch/csrc``, built with ``nvcc`` at first use).
* ``tpgsd_torch.io_runtime`` - asynchronous frame dump of torch tensors
  into ``tpgsd_torch.parallel.ShardedFrameWriter``.
* ``tpgsd_torch.format`` / ``fl`` / ``hoomd`` / ``io`` / ``parallel`` /
  ``utils`` - the port's own copy of the GSD write/read-back stack
  (numpy + a C++ positioned-I/O engine built with ``g++`` at first use);
  files are byte-identical to the JAX package's.
* ``tpgsd_torch.entry`` - the flagship dam-break step, in summation or
  continuity density mode.
* ``python -m tpgsd_torch`` (the ``tpgsd-torch`` script) - the command
  line: ``read``, ``info``, ``dump``, ``verify``, ``convert``.

The file layers (``format`` / ``io`` / ``fl`` / ``pypgsd`` / ``hoomd`` /
``vtu``) and the command line import only numpy and the standard
library, so they run on a machine without torch; the producer imports
torch.  No module imports JAX or anything of the JAX package ``tpgsd``,
which is the reference the port is tested against.

Importing the package turns SIGTERM into ``SystemExit(1)`` in the main
thread, as the reference does: the ``with`` blocks unwind, so open files
flush and an ``AsyncDumpRunner`` drains the frames already submitted
before the process exits (a batch scheduler's pre-emption sends this
signal to a running simulation).
"""

import signal
import sys

from .version import version  # noqa: F401

__version__ = version


def _sigterm_handler(signum, frame):
    # Exit cleanly on SIGTERM so open files flush their buffers and
    # queued frames reach the disk (reference: pgsd/pgsd/__init__.py:23-26).
    sys.exit(1)


try:
    signal.signal(signal.SIGTERM, _sigterm_handler)
except ValueError:
    # Not in the main thread of the main interpreter; skip installing the
    # handler (e.g. when imported from a worker thread).
    pass
