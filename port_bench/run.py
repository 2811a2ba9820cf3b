"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
loop, limits and metrics are found by name (``harness.py``). With
``--trace 0`` the result line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
of the profiler session, and a breakdown. The numbers compared with the
reference are those that ``limits/<cell>.json`` names; each beside its
limit, they are the last lines on standard error and the ``checks`` key,
last, of the result line, which is the last line of standard output.

Exits 2 without a result where no CUDA card is there (or fewer than the
cell asks for), and 3 where a module of JAX or of the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from port_bench import harness, trace  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, manifest=None, root=harness.BENCH_DIR, device: str = "cuda", t_start: float = T_START) -> dict:
    """Run the cell; returns the result line. ``manifest``, ``root`` (where
    the configurations, mixes and limits are) and ``device`` let the tests
    drive a run on the CPU."""
    args = parse(argv)
    cell = harness.resolve(args.workload, manifest, root)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
            sys.exit(2)
        from port_bench import program

        program.set_build_root(harness.BUILD_ROOT)
        print(harness.power_limit(), file=sys.stderr)
    record = harness.load_loop(cell.traffic["loop"]).run(cell, args.seed, args.seconds, bool(args.trace),
                                                         torch.device(device), t_start)
    readings = dict(record["checks"])  # a limit with no reading fails: NaN
    checks = [harness.Check(name, readings.get(name, float("nan")), limit) for name, limit in cell.limits.items()]
    metrics = harness.read_metrics(cell, record, bool(args.trace))
    dev = harness.device_info(torch, cell.chips, record["memory_peak_bytes"]) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    result = {"correct": all(c.ok for c in checks), "attempted": record.get("attempted", 0), "failed": 0,
              "metrics": metrics, "device": dev}
    if args.trace and "session" in record:
        s = record["session"]
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = trace.breakdown(s)
        if "launches" in s:  # the path the traffic took: the program's counters beside the mix's count
            print(f"session launches {s['launches']}; self-attention calls long enough for the flash kernel "
                  f"{len(s.get('flash_calls', []))}", file=sys.stderr)
    bad = harness.forbidden_modules() + harness.reference_imports()
    if bad:
        print(f"refused: loaded or imported {bad}", file=sys.stderr)
        sys.exit(3)
    # a number the run could not read (NaN) is printed as null
    result["checks"] = {c.name: {"value": c.value if c.value == c.value else None, "limit": c.limit} for c in checks}
    print(f"set-up {record['setup_s']:.1f} s, window {record['window_s']:.1f} s, "
          f"reference {record['reference_s']:.1f} s, {result['attempted']} attempted", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
