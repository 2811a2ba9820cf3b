"""Readings that the limits of a cell are set from, at the cell's own size.

    python3 -m port_bench.calibrate --workload <cell> --seeds <n>... \\
        [--control_seeds <n>...] [--seconds <s>] [--out <file>]

In one process: the cell's run (set-up, a window of ``--seconds``, the
comparison with the reference) on each of ``--seeds``, which gives the
program's readings; then, on each of ``--control_seeds``, the reference
computed in the configuration's control precision (the nearest below the
one it states) put in the program's place. Prints one JSON line a
reading and the largest
program reading and smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from port_bench import harness, program


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload)
    device = torch.device("cuda")
    program.set_build_root(harness.BUILD_ROOT)
    loop = harness.load_loop(cell.traffic["loop"])
    readings = {"program": [], "control": []}

    def note(kind, seed, checks):
        row = {"kind": kind, "seed": seed, **dict(checks)}
        readings[kind].append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        note("program", seed, loop.run(cell, seed, args.seconds, False, device, time.perf_counter())["checks"])
    for seed in args.control_seeds:
        note("control", seed, loop.control_checks(cell, seed, device, cell.config["control"]))
    summary = {}
    for kind, rows in readings.items():
        if rows:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0] if k not in ("kind", "seed")}
    print(json.dumps({"summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cell": cell.name, "readings": readings, "summary": summary}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
