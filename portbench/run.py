#!/usr/bin/env python3
"""The benchmark of ``tpgsd_torch`` on one NVIDIA card: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload dambreak-1M.dump32 --seed 7 \\
        --seconds 12 --trace 0

Prints the run's checks on standard error (each compared number beside
its limit, last) and one JSON object as the last line of standard
output.  Without a card (or with fewer than the cell asks for) it exits
with 2 and prints no result; if JAX or the JAX package ``tpgsd`` is
loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import harness

    marks = [("interpreter and imports", time.perf_counter())]
    cell = harness.load_cell(args.workload, REPO)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("portbench: %s needs %d CUDA device(s); this machine has %d"
              % (cell.name, cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    power = harness.power_limit()
    marks.append(("nvidia-smi", time.perf_counter()))
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START,
                                      marks=marks)
    found = harness.forbidden_modules()
    if found:
        print("portbench: loaded after the window: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power
    for name, value, limit in checks:
        print("check %s: %r limit %r" % (name, value, limit),
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
