"""On the card: decompose the flash kernel's time outside its products.

The counterpart of the JAX package's ``tools/vpu_probe.py``. Structural
variants of one streaming kernel (``flash_shift``), each deleting or
shrinking one pass over the score tile, timed in interleaved rounds:

  prod   the online max (K1's body, with the ones-column denominator).
  nomax  a constant shift C = 16: no max pass, no α rescale.
  bf16s  the score tile rounded to bf16 before mask, max and exp2.
  noexp  exp2 replaced by the identity (timing only; masked keys 0).
  bound  the per-row Cauchy-Schwarz shift ``qk_shift_bound`` (+1), clamp
         −80, mask after exp2: nomax made safe. Its timed call includes
         computing the shift, as the JAX probe's did ("bound kernel": the
         kernel alone).

K1 is timed beside them. Accuracy: each variant against K1 at T, and
against the f32 plain version at min(T, 4096).

    python -m said_tpu_torch.probes.vpu_probe [--t 21600] [--iters 10] [--dtype bfloat16]
    python -m said_tpu_torch.probes.vpu_probe --device cpu --t 256
"""

from __future__ import annotations

import functools

import numpy as np

from said_tpu_torch.ops import attention
from said_tpu_torch.probes import _cli
from said_tpu_torch.probes.flash_shift import VARIANTS, flash_shift, flash_shift_plain
from said_tpu_torch.probes.shift import VPU_CLAMP, qk_shift_bound
from said_tpu_torch.probes.timing import paired_wins, time_rounds

B, H, D = 2, 6, 32
INNER = H * D
DENSE_T = 4096


def run(q, k, v, variant):
    """One variant; bound computes its shift in the call."""
    if variant == "bound":
        return flash_shift(q, k, v, "bound", qk_shift_bound(q, k, H), VPU_CLAMP)
    return flash_shift(q, k, v, variant)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__, t=21600, iters=10)
    args = ap.parse_args(argv)
    dev, dt = _cli.device_of(args), _cli.DTYPES[args.dtype]
    t = args.t
    shape = (B, t, INNER)
    q, k, v = _cli.inputs(np.random.default_rng(0), shape, 3, dt, dev)
    print(f"# T={t} B={B} H={H} D={D} {args.dtype} on {_cli.where(dev)}")
    result = {"t": t, "dtype": args.dtype, "inputs": {"shape": shape, "heads": H},
              "variants": {name: {} for name in VARIANTS}}
    k1 = attention.flash_attention_kernel if dev.type == "cuda" else attention.flash_attention_plain
    prod = k1(q, k, v, H)
    print(f"accuracy vs the production kernel K1 @ T={t} ({args.dtype} in/out):", flush=True)
    outs = {}
    for name in VARIANTS:
        outs[name] = run(q, k, v, name)
        if name != "noexp":
            result["variants"][name]["vs_k1"] = _cli.max_abs_diff(outs[name], prod)
            print(f"  {name}: max|Δ| = {result['variants'][name]['vs_k1']:.3e}", flush=True)
    ts = min(t, DENSE_T)
    qs, ks, vs = (x[:, :ts].contiguous() for x in (q, k, v))
    dense = flash_shift_plain(qs.float(), ks.float(), vs.float(), "prod")  # the f32 oracle
    print(f"accuracy vs f32 dense @ T={ts}:", flush=True)
    for name in ("prod", "nomax", "bf16s", "bound"):
        result["variants"][name]["vs_dense"] = _cli.max_abs_diff(run(qs, ks, vs, name), dense)
        print(f"  {name}: max|Δ| = {result['variants'][name]['vs_dense']:.3e}", flush=True)
    if dev.type == "cpu":
        return result

    shift = qk_shift_bound(q, k, H)
    for name in VARIANTS:
        want = flash_shift_plain(q, k, v, name, shift if name == "bound" else None, VPU_CLAMP)
        result["variants"][name]["rel_err_vs_plain"] = _cli.rel_err(outs[name], want)
    fns = {name: functools.partial(run, q, k, v, name) for name in VARIANTS}
    fns["bound kernel"] = functools.partial(flash_shift, q, k, v, "bound", shift, VPU_CLAMP)
    fns["K1"] = _cli.k1_thunk(q, k, v, H)
    ms = time_rounds(fns, args.iters, args.rounds)
    for r in range(args.rounds):
        for name in VARIANTS:
            print(f"round {r} {name:>6}: {ms[name].rounds[r]:7.3f} ms/call", flush=True)
    base = ms["prod"].median
    print("\nmedians:", flush=True)
    for name, m in ms.items():
        wins = paired_wins(ms["prod"], m)
        print(f"  {name:>12}: {m.median:7.3f} ms  ({base / m.median:.3f}x vs prod, wins {wins}/{args.rounds} "
              f"paired rounds)  [{m.lo:.3f}–{m.hi:.3f}]", flush=True)
        entry = {"ms": m.median, "lo": m.lo, "hi": m.hi, "wins_vs_prod": wins}
        (result["variants"][name] if name in VARIANTS else result.setdefault(name, {})).update(entry)
    print(f"# prod / K1: {base / ms['K1'].median:.3f}")
    return result


if __name__ == "__main__":
    main()
