"""What the five probe CLIs share: their flags, their seeded inputs and
the yardstick (K1, the serving path's flash kernel, timed beside the
probes and never called by a probe kernel). Library calls
(PyTorch's SDPA, ``torch._int_mm``) are timed beside the
CLIs by ``chip_smoke.py`` phase 28, never in the port."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from said_tpu_torch.ops import attention

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parser(doc: str, t: int, iters: int, dtype: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--t", type=int, default=t, help="frames (queries and keys)")
    ap.add_argument("--iters", type=int, default=iters, help="calls a CUDA graph replays")
    ap.add_argument("--rounds", type=int, default=6, help="interleaved timing rounds")
    ap.add_argument("--device", default="cuda", help="cuda (time the kernels) or cpu (the plain versions' numerics)")
    if dtype:
        ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return ap


def device_of(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: run on one, or pass --device cpu for the plain versions' numerics")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {args.device}: cuda or cpu")
    return dev


def whole_tiles(t: int, key_tile: int) -> None:
    """Refuse a T that is no multiple of the kernel's key tile (a multiple
    of its 64 query rows too): the stages are defined on whole tiles."""
    if t % key_tile:
        raise SystemExit(f"--t {t} must be a multiple of the kernel's key tile {key_tile}")


def inputs(rng: np.random.Generator, shape, n: int, dtype, dev) -> list:
    """``n`` standard-normal tensors drawn in turn from ``rng``, as the JAX
    probes draw theirs."""
    return [torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype) for _ in range(n)]


def where(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "cpu (plain versions, numerics only)"
    from said_tpu_torch.probes.timing import card_line

    return card_line()


def k1_thunk(q, k, v, h):
    """K1, the flash kernel of the serving path, on the same tensors."""
    return lambda: attention.flash_attention_kernel(q, k, v, h)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())
