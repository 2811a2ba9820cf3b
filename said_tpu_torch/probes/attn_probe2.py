"""Probe 2 on the card: the packed layout against the per-head layout.

The counterpart of the JAX package's ``tools/attn_probe2.py``. The TPU
probe asked whether (·, 32)-minor blocks of the per-head layout cost data
movement that the model's natural packed (B, T, H·D = 192) layout saves.
Here ``flash_stages``'s copy and full stages run on both layouts of the
same tensors (the packed rows of 384 bytes against rows of 64), beside K1
(packed, the serving path's layout), which takes the place of the TPU
tool's block-size sweep and XLA's dense attention: the kernel's tiles are
fixed on the card (``chip_smoke.py`` phase 28 times
PyTorch's SDPA beside it).

    python -m said_tpu_torch.probes.attn_probe2 [--t 4096] [--iters 30] [--dtype bfloat16]
    python -m said_tpu_torch.probes.attn_probe2 --device cpu --t 256
"""

from __future__ import annotations

import functools

import numpy as np

from said_tpu_torch.probes import _cli
from said_tpu_torch.probes.flash_stages import KEY_TILE, ROW_TILE, flash_stages, flash_stages_plain
from said_tpu_torch.probes.timing import PRODUCT_FLOP_PER_S, time_rounds

B, H, D = 2, 6, 32
INNER = H * D
MODES = ("copy", "full")


def per_head(x):
    """(B, T, H·D) -> (B·H, T, D), contiguous: the per-head layout."""
    b, t, _ = x.shape
    return x.reshape(b, t, H, D).transpose(1, 2).reshape(b * H, t, D).contiguous()


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__, t=4096, iters=30)
    args = ap.parse_args(argv)
    dev, dt = _cli.device_of(args), _cli.DTYPES[args.dtype]
    t = args.t
    _cli.whole_tiles(t, KEY_TILE[dt])
    shape = (B, t, INNER)
    q, k, v = _cli.inputs(np.random.default_rng(0), shape, 3, dt, dev)
    print(f"# T={t} tiles {ROW_TILE}x{KEY_TILE[dt]} B={B} H={H} D={D} {args.dtype} on {_cli.where(dev)}")
    dense = flash_stages_plain(q.float(), k.float(), v.float(), "full", "packed")  # the f32 oracle
    got = flash_stages(q, k, v, "full", "packed")
    err = _cli.max_abs_diff(got, dense)
    print(f"# packed full kernel max err vs dense: {err:.4f}", flush=True)
    result = {"t": t, "dtype": args.dtype, "inputs": {"shape": shape, "heads": H}, "max_err_vs_dense": err,
              "modes": {}}
    if dev.type == "cpu":
        for mode in MODES:
            out = flash_stages(q, k, v, mode, "packed")
            print(f"{mode:>18}: ok  max|out| {out.float().abs().max():.4e}", flush=True)
        return result

    qh, kh, vh = per_head(q), per_head(k), per_head(v)
    for mode in MODES:
        result["modes"][mode] = {"max_rel_err": _cli.rel_err(flash_stages(q, k, v, mode, "packed"),
                                                             flash_stages_plain(q, k, v, mode, "packed"))}
    fns = {f"{mode}_packed": functools.partial(flash_stages, q, k, v, mode, "packed") for mode in MODES}
    fns.update({f"{mode}_per_head": functools.partial(flash_stages, qh, kh, vh, mode, "head") for mode in MODES})
    fns["K1"] = _cli.k1_thunk(q, k, v, H)
    ms = time_rounds(fns, args.iters, args.rounds)
    flop = 4 * B * H * t * t * D
    peak = PRODUCT_FLOP_PER_S[dt]
    for name, m in ms.items():
        mfu = "" if name.startswith("copy") else f"  (MFU {100 * flop / (m.median * 1e-3) / peak:4.1f}%)"
        print(f"{name:>18}: {m.median:7.3f} ms  [{m.lo:.3f}–{m.hi:.3f}]{mfu}", flush=True)
        entry = {"ms": m.median, "lo": m.lo, "hi": m.hi}
        if name.endswith("_packed"):
            result["modes"][name.removesuffix("_packed")].update(entry)
        else:
            result[name] = entry
    print(f"# full packed / K1: {ms['full_packed'].median / ms['K1'].median:.3f}")
    return result


if __name__ == "__main__":
    main()
