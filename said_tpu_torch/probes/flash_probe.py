"""The launcher of ``csrc/probes/flash_probe.cu``: K1's loop with three
knobs (where the body is cut, the exp2 shift, the denominator), the one
kernel behind probes P1 and P2 (``flash_stages``) and P3 and P5
(``flash_shift``). Those modules hold the plain versions and check their
arguments; this one launches the kernel and counts its launches.
"""

from __future__ import annotations

import torch

from said_tpu_torch import _build
from said_tpu_torch.probes import HEAD_DIM, check_cuda

STAGES = ("copy", "qk", "qk_max", "qk_max_exp", "qk_max_exp_sum", "full")
VARIANTS = ("prod", "nomax", "bf16s", "noexp", "bound")
ROW_TILE = 64
KEY_TILE = {torch.float32: 64, torch.bfloat16: 128}


def flash_probe_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stage: str = "full",
                       variant: str = "prod", ones: bool = False, shift: torch.Tensor | None = None,
                       floor: float = 0.0) -> torch.Tensor:
    """Launch ``said_probe_flash`` on contiguous CUDA tensors q (B, T, H·32)
    and k, v (B, S, H·32) of one dtype (float32, bfloat16); the per-head
    layout (B·H, T, 32) is H = 1. A stage before ``full`` takes prod and
    no ones column, and whole tiles: T a multiple of ``ROW_TILE``, S of
    the key tile. ``bound`` takes a (B, T, H) float32 shift."""
    name = "flash_probe_kernel"
    check_cuda(name, q, k, v, *(() if shift is None else (shift,)))
    b, t, inner = q.shape
    out = torch.empty_like(q)
    err = _build.probe_library().said_probe_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if shift is None else shift.data_ptr(),
        out.data_ptr(), b, t, k.shape[1], inner // HEAD_DIM, STAGES.index(stage),
        VARIANTS.index(variant), int(ones), float(floor), _build.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    flash_probe_kernel.launches += 1
    return out


flash_probe_kernel.launches = 0
