#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload dambreak-1M.silent \\
        --seeds 11,12,13 --seconds 12 [--out readings.jsonl]

For each seed, one whole run of the cell (its window at ``--seconds``)
in this one process, and on the same two checked steps the control: the
reference's step computed in bfloat16, put in the program's place.
Prints a line a seed and, last, each compared number's lower reading
(the largest the program gives) and upper reading (the smallest the
control gives).
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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload, REPO)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    power = harness.power_limit()
    lines = []
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     t, control=True)
        t = time.perf_counter()
        line = {"workload": cell.name, "seed": seed,
                "correct": result["correct"], "gaps": result["gaps"],
                "control": result["control"],
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()},
                "power_limit": power}
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {}
    for k in lines[0]["gaps"]["first"]:
        prog = [max(l["gaps"]["first"][k], l["gaps"]["last"][k])
                for l in lines]
        ctrl = [min(l["control"]["first"][k], l["control"]["last"][k])
                for l in lines]
        summary[k] = {"lower": max(prog), "upper": min(ctrl),
                      "program": prog, "control": ctrl}
    print(json.dumps({"summary": summary, "workload": cell.name,
                      "seeds": len(lines), "power_limit": power}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
