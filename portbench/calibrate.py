#!/usr/bin/env python3
"""Read the numbers that decide `correct` over many seeds, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        [--control-seeds 3] [--fault-seeds 3] [--seconds 1] [--out FILE]

runs the cell in one process once per seed with a short window: the
program on `--seeds` seeds (the lower readings), the control on
`--control-seeds` (the reference computed in TF32, put in the program's
place: its upper readings), and each fault the cell can have on
`--fault-seeds` (training: the loss over half of each batch; serving: one
answer of each call altered). A step that leaves the state unchanged
reads 1 by the leaf measure and needs no run. Every reading is printed
as a JSON line (and appended to --out), a training cell's with the three
leaves of the largest change gap. The benchmark's own runs never
run this: the limits in reference/limits/<cell>.json are set from its
readings (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

FAULTS = {"train": ["half_batch"], "rerank": ["altered"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="default: the first card")
    args = p.parse_args(argv)

    from portbench.run import cell_setup, load_json, run_cell, ROOT

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    kind = cell_setup(bench, args.workload)[2]["kind"]
    runs = ([(None, None)] * args.seeds + [("tf32", None)] * args.control_seeds
            + [(None, f) for f in FAULTS[kind] for _ in range(args.fault_seeds)])
    readings, cache = {}, {}
    for i, (control, fault) in enumerate(runs):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        result, outcome = run_cell(args.workload, seed, args.seconds, False,
                                   device=args.device, control=control, fault=fault,
                                   t0=time.perf_counter(), cache=cache)
        what = control or fault or "program"
        line = {"workload": args.workload, "what": what, "seed": seed,
                "correct": result["correct"],
                "numbers": {k: v["value"] for k, v in result["compared"].items()},
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "seconds": time.perf_counter() - t,
                "worst_change_leaves": outcome.leaves}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        for k, v in line["numbers"].items():
            readings.setdefault((what, k), []).append(v)
    for (what, k), vs in sorted(readings.items()):
        print(f"{what:10s} {k:12s} min {min(vs):.6g} max {max(vs):.6g} n {len(vs)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
