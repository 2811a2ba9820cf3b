"""Decompose the flash kernel's time on the card, one softmax stage at a time.

The counterpart of the JAX package's ``tools/attn_probe.py``: a family of
kernels (``flash_stages``, per-head layout (B·H, T, D)) that start from a
copy-only body and add one stage at a time (QK^T, running max, exp, sum,
PV with the rescale). The per-stage deltas show what holds the kernel.
Shapes: the UNet's self-attention (B = 2, H = 6, D = 32), T a multiple
of the kernel's key tile (its tiles are fixed). Beside the stages: K1 on the same tensors (H = 1 per batch row),
the yardstick that replaces the TPU tool's stock flash kernel
(``chip_smoke.py`` phase 28 times PyTorch's SDPA beside
it).

    python -m said_tpu_torch.probes.attn_probe [--t 4096] [--iters 30] [--dtype bfloat16]
    python -m said_tpu_torch.probes.attn_probe --device cpu --t 256   # the plain versions' numerics
"""

from __future__ import annotations

import functools

import numpy as np

from said_tpu_torch.probes import _cli
from said_tpu_torch.probes.flash_stages import KEY_TILE, ROW_TILE, STAGES, flash_stages, flash_stages_plain
from said_tpu_torch.probes.timing import PRODUCT_FLOP_PER_S, time_rounds

B, H, D = 2, 6, 32


def stage_work(stage: str, n: int, t: int, s: int, isz: int) -> dict:
    """What a stage must do: bytes moved (q, k, v read, out written), product
    FLOP, exp2 (one a (query, key) pair from qk_max_exp on)."""
    pairs = n * t * s
    product = {"copy": 0, "full": 4 * pairs * D}.get(stage, 2 * pairs * D)
    exp2 = pairs if stage in ("qk_max_exp", "qk_max_exp_sum", "full") else 0
    reads = {"copy": 1, "full": 3}.get(stage, 2)
    return {"bytes": (reads * n * t * D + n * t * D) * isz, "product_flop": product, "exp2": exp2}


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__, t=4096, iters=30)
    args = ap.parse_args(argv)
    dev, dt = _cli.device_of(args), _cli.DTYPES[args.dtype]
    t = args.t
    _cli.whole_tiles(t, KEY_TILE[dt])
    shape = (B * H, t, D)
    q, k, v = _cli.inputs(np.random.default_rng(0), shape, 3, dt, dev)
    print(f"# T={t} tiles {ROW_TILE}x{KEY_TILE[dt]} B*H={B * H} D={D} {args.dtype} on {_cli.where(dev)}")
    result = {"t": t, "dtype": args.dtype, "inputs": {"shape": shape, "heads": 1}, "stages": {}}
    if dev.type == "cpu":
        for stage in STAGES:
            out = flash_stages(q, k, v, stage, "head")
            print(f"{stage:>16}: ok  max|out| {out.float().abs().max():.4e}", flush=True)
            result["stages"][stage] = {"max_abs_out": float(out.float().abs().max())}
        return result

    for stage in STAGES:  # each kernel against its plain version at the kernel's tile
        got, want = flash_stages(q, k, v, stage, "head"), flash_stages_plain(q, k, v, stage, "head")
        result["stages"][stage] = {"max_rel_err": _cli.rel_err(got, want)}
    fns = {stage: functools.partial(flash_stages, q, k, v, stage, "head") for stage in STAGES}
    fns["K1"] = _cli.k1_thunk(q, k, v, 1)
    ms = time_rounds(fns, args.iters, args.rounds)
    prev = 0.0
    isz = q.element_size()
    for stage in STAGES:
        m, work = ms[stage], stage_work(stage, B * H, t, t, isz)
        rate = ""
        if work["product_flop"]:
            tf = work["product_flop"] / m.median * 1e-9
            rate += f"  {tf:6.1f} TFLOP/s ({100 * tf * 1e12 / PRODUCT_FLOP_PER_S[dt]:4.1f}% of peak)"
        if work["exp2"]:
            rate += f"  exp2 {work['exp2'] / m.median * 1e-9:6.3f} T/s"
        print(f"{stage:>16}: {m.median:7.3f} ms  (+{m.median - prev:6.3f})  [{m.lo:.3f}–{m.hi:.3f}]{rate}  "
              f"max rel err vs plain {result['stages'][stage]['max_rel_err']:.2e}", flush=True)
        prev = m.median
        result["stages"][stage].update(ms=m.median, lo=m.lo, hi=m.hi, work=work)
    k1 = ms["K1"]
    print(f"{'K1':>16}: {k1.median:7.3f} ms  [{k1.lo:.3f}–{k1.hi:.3f}]", flush=True)
    result["K1"] = {"ms": k1.median, "lo": k1.lo, "hi": k1.hi}
    print(f"# full / K1: {ms['full'].median / ms['K1'].median:.3f}")
    return result


if __name__ == "__main__":
    main()
