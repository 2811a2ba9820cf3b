"""On the card: the bound-shift (max-free) variant of the flash kernel
against the production online max, at the headline shape (T = 3600).

The counterpart of the JAX package's ``tools/fullk_bound_probe.py``. There,
the full-K TPU kernel kept its per-row max over the whole score block and
a mirrored variant shifted exp2 by ``_exp2_shift_bound`` instead (min of
the Cauchy-Schwarz bound and the landmark max + 64, clamp −120, masked to
0 after exp2). Here both are ``flash_shift`` variants, ``bound`` and
``prod``, streaming key tiles like K1; K1 itself is timed beside them.
The bound's timed call includes computing the shift, as the JAX probe's
did; "bound kernel" is the kernel alone.

Decision rule (the JAX probe's): a > 5% win with at least 5 of 6 paired
interleaved rounds.

    python -m said_tpu_torch.probes.fullk_bound_probe [--t 3600] [--iters 20] [--dtype bfloat16]
    python -m said_tpu_torch.probes.fullk_bound_probe --device cpu --t 256
"""

from __future__ import annotations

import functools

import numpy as np

from said_tpu_torch.probes import _cli
from said_tpu_torch.probes.flash_shift import flash_shift, flash_shift_plain
from said_tpu_torch.probes.shift import SHIFT_CLAMP, exp2_shift_bound, fold_q
from said_tpu_torch.probes.timing import paired_wins, time_rounds

B, H, D = 2, 6, 32
INNER = H * D


def bound_call(q, k, v):
    """The bound variant with its shift computed in the call."""
    return flash_shift(q, k, v, "bound", exp2_shift_bound(fold_q(q), k, H), SHIFT_CLAMP)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__, t=3600, iters=20)
    args = ap.parse_args(argv)
    dev, dt = _cli.device_of(args), _cli.DTYPES[args.dtype]
    t = args.t
    shape = (B, t, INNER)
    q, k, v = _cli.inputs(np.random.default_rng(0), shape, 3, dt, dev)
    print(f"# T={t} B={B} H={H} D={D} {args.dtype} on {_cli.where(dev)}")
    prod_out, bound_out = flash_shift(q, k, v, "prod"), bound_call(q, k, v)
    result = {"t": t, "dtype": args.dtype, "inputs": {"shape": shape, "heads": H},
              "bound_vs_prod": _cli.max_abs_diff(bound_out, prod_out)}
    print(f"bound vs prod @T={t}: max|d| = {result['bound_vs_prod']:.3e}", flush=True)
    dense = flash_shift_plain(q.float(), k.float(), v.float(), "prod")  # the f32 oracle
    for name, out in (("prod", prod_out), ("bound", bound_out)):
        result[f"{name}_vs_dense"] = _cli.max_abs_diff(out, dense)
        print(f"  {name} vs f32 dense: max|d| = {result[f'{name}_vs_dense']:.3e}", flush=True)
    if dev.type == "cpu":
        return result

    shift = exp2_shift_bound(fold_q(q), k, H)
    for name, got, want in (("prod", prod_out, flash_shift_plain(q, k, v, "prod")),
                            ("bound", bound_out, flash_shift_plain(q, k, v, "bound", shift, SHIFT_CLAMP))):
        result[f"{name}_rel_err_vs_plain"] = _cli.rel_err(got, want)
    fns = {"prod": functools.partial(flash_shift, q, k, v, "prod"), "bound": functools.partial(bound_call, q, k, v),
           "bound kernel": functools.partial(flash_shift, q, k, v, "bound", shift, SHIFT_CLAMP),
           "K1": _cli.k1_thunk(q, k, v, H)}
    ms = time_rounds(fns, args.iters, args.rounds)
    for r in range(args.rounds):
        for name in ("prod", "bound"):
            print(f"round {r} {name:>5}: {ms[name].rounds[r]:7.4f} ms/call", flush=True)
    wins = paired_wins(ms["prod"], ms["bound"])
    print(f"\nmedians: prod {ms['prod'].median:.4f} ms, bound {ms['bound'].median:.4f} ms -> "
          f"{ms['prod'].median / ms['bound'].median:.3f}x, bound wins {wins}/{args.rounds} paired rounds")
    for name in ("bound kernel", "K1"):
        print(f"{name:>12}: {ms[name]}", flush=True)
    print(f"# prod / K1: {ms['prod'].median / ms['K1'].median:.3f}")
    result.update({name: {"ms": m.median, "lo": m.lo, "hi": m.hi} for name, m in ms.items()}, bound_wins=wins)
    return result


if __name__ == "__main__":
    main()
