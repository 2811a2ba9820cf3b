"""Go/no-go probe on the card for int8 QK^T inside the flash kernel.

The counterpart of the JAX package's ``tools/int8_qk_probe.py``. The
denoiser's head dim is 32; the H100 runs int8 products at 1979 TOP/s
against 989 TFLOP/s for bf16, and one int8 wgmma covers D = 32. Stages
(``int8_qk``, per-head layout (B·H, T, D)):

- dot_bf16 / dot_int8: QK^T alone, the same wgmma family in both types:
  the card's ratio at this shape. A dot_int8 speedup under 1.5x is a
  no-go.
- full_bf16: the online-softmax body (QK, max, exp2, PV, ones column).
- full_int8qk: int8 QK^T -> int32 scores, the running max in raw int
  units, the dequantization folded into exp2's argument, PV in bf16.
- full_int8qkpv: p quantized to rint(p·127) and V to int8 as well, both
  products int8; the denominator column is the constant 127.

Per-tensor symmetric quantization, as the JAX probe's ``main``
(``shift.int8_inputs``); max |output − f32 dense| beside each full stage.
(``chip_smoke.py`` phase 28 times ``torch.matmul`` in bf16 and
``torch._int_mm`` beside the dot stages.)

    python -m said_tpu_torch.probes.int8_qk_probe [--t 14336] [--iters 24]
    python -m said_tpu_torch.probes.int8_qk_probe --device cpu --t 256   # replaces --interpret
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from said_tpu_torch.ops.attention import dense_attention
from said_tpu_torch.probes import _cli
from said_tpu_torch.probes.int8_qk import KEY_TILE, ROW_TILE, STAGES, int8_qk, int8_qk_plain
from said_tpu_torch.probes.shift import int8_inputs
from said_tpu_torch.probes.timing import PRODUCT_FLOP_PER_S, time_rounds

B, H, D = 1, 6, 32


def stage_args(x, stage):
    """(q, k, v) a stage takes from ``int8_inputs``'s tensors."""
    int8 = "int8" in stage
    v = None if stage.startswith("dot_") else x.v_i8 if stage == "full_int8qkpv" else x.v_bf
    return (x.q_i8, x.k_i8, v) if int8 else (x.q_bf, x.k_bf, v)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__, t=14336, iters=24, dtype=False)
    args = ap.parse_args(argv)
    dev = _cli.device_of(args)
    t = args.t
    _cli.whole_tiles(t, KEY_TILE)
    shape = (B * H, t, D)
    q32, k32, v32 = _cli.inputs(np.random.default_rng(0), shape, 3, torch.float32, dev)
    x = int8_inputs(q32, k32, v32)
    oracle = dense_attention(q32, k32, v32, 1)  # the f32 oracle, every head at once
    flops = 2 * (B * H) * t * t * D  # one QK^T pass
    print(f"# T={t} tiles {ROW_TILE}x{KEY_TILE} B*H={B * H} D={D} on {_cli.where(dev)}")
    result = {"t": t, "inputs": {"shape": shape, "heads": 1}, "stages": {}}
    outs = {}
    for stage in STAGES:
        q, k, v = stage_args(x, stage)
        if dev.type == "cpu":
            outs[stage] = int8_qk_plain(q, k, v, stage, x.dequant_log2, x.pv_scale)
        else:
            outs[stage] = int8_qk(q, k, v, stage, x.dequant_log2, x.pv_scale)
        entry = result["stages"][stage] = {}
        if stage.startswith("full_"):
            entry["max_err_vs_dense"] = _cli.max_abs_diff(outs[stage], oracle)
        if dev.type == "cpu":
            err = f"  max|err|={entry['max_err_vs_dense']:.3e}" if "max_err_vs_dense" in entry else ""
            print(f"{stage:>14}: ok{err}", flush=True)
    if dev.type == "cpu":
        return result

    for stage in STAGES:
        want = int8_qk_plain(*stage_args(x, stage), stage, x.dequant_log2, x.pv_scale)
        result["stages"][stage]["max_rel_err_vs_plain"] = _cli.rel_err(outs[stage], want)
    fns = {stage: functools.partial(int8_qk, *stage_args(x, stage), stage, x.dequant_log2, x.pv_scale)
           for stage in STAGES}
    ms = time_rounds(fns, args.iters, args.rounds)
    for stage in STAGES:
        m, entry = ms[stage], result["stages"][stage]
        peak = PRODUCT_FLOP_PER_S[torch.int8 if "int8" in stage else torch.bfloat16]
        err = f"  max|err|={entry['max_err_vs_dense']:.3e}" if "max_err_vs_dense" in entry else ""
        eff = flops / (m.median * 1e-3) / 1e12
        print(f"{stage:>14}: {m.median:8.3f} ms  {eff:6.1f} Top/s ({100 * eff * 1e12 / peak:4.1f}% of peak) "
              f"[{m.lo:.3f}–{m.hi:.3f}]  vs plain {entry['max_rel_err_vs_plain']:.2e}{err}", flush=True)
        entry.update(ms=m.median, lo=m.lo, hi=m.hi)
    t_ = {stage: ms[stage].median for stage in STAGES}
    r = t_["dot_bf16"] / t_["dot_int8"]
    print(f"# dot int8 speedup: {r:.2f}x  ({'GO' if r >= 1.5 else 'NO-GO'} for kernel work)")
    print(f"# full-kernel int8-QK speedup: {t_['full_bf16'] / t_['full_int8qk']:.2f}x")
    print(f"# full-kernel int8-QK+PV speedup: {t_['full_bf16'] / t_['full_int8qkpv']:.2f}x")
    result.update(dot_speedup=r, full_qk_speedup=t_["full_bf16"] / t_["full_int8qk"],
                  full_qkpv_speedup=t_["full_bf16"] / t_["full_int8qkpv"])
    return result


if __name__ == "__main__":
    main()
