#!/usr/bin/env python3
"""Readings for setting a cell's limits, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control float8] [--control-seeds 1,2,3] [--faults half,unchanged] [--out FILE]

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own load, then the check's numbers for the program (the lower readings).
For each control seed: the same set-up and window, then the reference in
the control precision put in the program's place, and each named fault
planted in the reference (training cells), against the reference (the
upper readings). One JSON line a reading, also appended to ``--out``.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark.core import files

    work = files.workload(args.workload)
    conf = files.config(work["config"])
    check = files.module("checks", work["loop"])
    make = files.module("loops", work["loop"]).Loop

    def say(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def prepared(seed: int):
        loop = make(conf, work, seed, args.device)
        loop.setup()
        loop.run(args.seconds)
        if hasattr(loop, "record"):
            loop.record()
        loop.release()
        return loop

    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        loop = prepared(seed)
        say({"cell": args.workload, "seed": seed, "what": "program", **check.readings(loop),
             "seconds": time.perf_counter() - t0})
        del loop
    for seed in cseeds:
        loop = prepared(seed)
        if args.control:
            say({"cell": args.workload, "seed": seed, "what": f"control {args.control}",
                 **check.control(loop, args.control)})
        for name in [f for f in args.faults.split(",") if f]:
            say({"cell": args.workload, "seed": seed, "what": f"fault {name}",
                 **check.fault(loop, name)})
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
