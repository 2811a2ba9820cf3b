"""Time the LayerNorm and strided-conv kernels of several checkouts on one
card, in turns: the comparison of a change with its parent.

    python -m said_tpu_torch.kernel_ab --trees PARENT . . PARENT [--out ab.json]

Each entry of ``--trees`` is the root of a checkout; each runs, in the
order given, in a process of its own that imports that checkout's
``said_tpu_torch`` (and builds its kernels there at first use) and times
its ``layer_norm_kernel`` and ``strided_conv_gelu_kernel`` at the main
path's shapes with this file's timing: ``device_ms`` on the card alone
(as many calls as timed turns, captured in one CUDA graph and replayed
between CUDA events) and ``ms``, the median of CUDA events around one call
on an idle card (the host's enqueue counted). Inputs come from fixed
seeds, so every tree sees the same data. The medians over a tree's runs
are printed and written to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (B, T, C) of the LayerNorm calls: the UNet at 10 s, 60 s and 6 min; the
# encoder's feature projection at 10 s and its layers at 50 s and 5 min
LN_SHAPES = ((2, 600, 192), (2, 3600, 192), (2, 21600, 192), (1, 600, 512), (1, 2999, 768), (1, 17999, 768))
# (K, T_in) of conv_1 … conv_6 of a 10-s clip, 512 -> 512 channels
CONV_SHAPES = ((3, 31999), (3, 15999), (3, 7999), (3, 3999), (2, 1999), (2, 999))
ITERS = 20


def _worker(tree: str) -> None:
    sys.path[0] = os.path.abspath(tree)  # this checkout's said_tpu_torch, not the one beside this file
    import numpy as np
    import torch

    from said_tpu_torch.ops import conv, norms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def randn(shape, seed, dtype, scale=1.0, offset=0.0):
        a = np.random.default_rng(seed).standard_normal(shape) * scale + offset
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(ITERS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            enqueue.append(start.elapsed_time(end))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return {"ms": statistics.median(enqueue), "device_ms": start.elapsed_time(end) / ITERS}

    pack = getattr(conv, "pack_weight", lambda w: w)  # a tree whose kernel reads the weight as given
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for shape in LN_SHAPES:
            c = shape[-1]
            x, w, b = randn(shape, 1, dt, 2.0, 0.5), randn((c,), 2, torch.float32), randn((c,), 3, torch.float32)
            out[f"layer_norm {tag} {shape}"] = timed(lambda: norms.layer_norm_kernel(x, w, b, 1e-5))
        for k, t_in in CONV_SHAPES:
            x, w = randn((1, t_in, 512), 12, dt), pack(randn((k, 512, 512), 13, dt, 0.03))
            out[f"strided_conv_gelu {tag} K={k} T_in={t_in}"] = timed(lambda: conv.strided_conv_gelu_kernel(x, w))
    print("KERNEL_AB " + json.dumps(out))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trees", nargs="+", required=True, metavar="ROOT")
    parser.add_argument("--out", default="")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker)
        return {}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    runs = {}
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trees", tree, "--worker", tree],
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("KERNEL_AB ")), None)
        if proc.returncode != 0 or line is None:
            raise SystemExit(f"kernel_ab: the run of {tree} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        runs.setdefault(os.path.abspath(tree), []).append(json.loads(line[len("KERNEL_AB "):]))
    summary = {}
    for tree, rs in runs.items():
        summary[tree] = {case: {key: statistics.median(r[case][key] for r in rs) for key in ("ms", "device_ms")}
                         for case in rs[0]}
    for case in next(iter(summary.values())):
        print(f"{case:42s} " + "  ".join(f"{os.path.relpath(tree)}: device {s[case]['device_ms']:.4f} ms, "
                                        f"+enq {s[case]['ms']:.4f} ms" for tree, s in summary.items()))
    result = {"gpu": gpu, "trees": args.trees, "summary": summary, "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
