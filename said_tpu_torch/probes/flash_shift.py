"""K1's body with a ones-column denominator and the exp2 shift as a knob
(probes P3 and P5).

Port of the Pallas probes ``tools/fullk_bound_probe.py::fullk_bound``
(:52, the full-K kernel under the precomputed ``_exp2_shift_bound``) and
``tools/vpu_probe.py::blocked_variant`` (:95, the key-blocked kernel with
one knob changed) as one streaming kernel: the variant knob of
``csrc/probes/flash_probe.cu`` under its ones-column denominator (its
source note says what each variant deletes and what bounds it).
Variants: ``prod`` (the online max of K1/K2), ``nomax`` (a constant shift
16), ``bf16s`` (the score tile rounded to bf16), ``noexp`` (exp2 replaced
by the identity, masked keys 0) and ``bound`` (a per-row shift (B, T, H)
and a clamp floor: −120 for P3, −80 for P5). ``flash_shift`` routes: the
plain version on the CPU, the kernel on CUDA.
"""

from __future__ import annotations

import torch

from said_tpu_torch.probes import HEAD_DIM
from said_tpu_torch.probes.flash_probe import KEY_TILE, VARIANTS, flash_probe_kernel
from said_tpu_torch.probes.shift import SHIFT_CLAMP, fold_q

NOMAX_SHIFT = 16.0
_MAXED = ("prod", "bf16s", "noexp")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_shift_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                      shift: torch.Tensor | None = None, floor: float = SHIFT_CLAMP,
                      block_k: int | None = None) -> torch.Tensor:
    """Plain version of the shift kernel with its numerics: q (B, T, H·32),
    k/v (B, S, H·32); Q folded and rounded as K1; f32 scores s in exp2
    units over key blocks of ``block_k`` (default the kernel's tile); p by
    the variant, rounded to V's dtype; the ones column's sum of the same
    rounded p as the denominator."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    if (variant == "bound") != (shift is not None):
        raise ValueError("a shift is given exactly for the bound variant")
    dt = q.dtype
    block_k = block_k or KEY_TILE[dt]
    b, t, inner = q.shape
    s = k.shape[1]
    h = inner // HEAD_DIM

    def heads(x, n):
        return x.float().reshape(b, n, h, HEAD_DIM).transpose(1, 2)

    qs = heads(fold_q(q), t)
    kh, vh = heads(k, s), heads(v, s)
    a = None if shift is None else shift.float().transpose(1, 2)[..., None]  # (b, h, t, 1)
    m = torch.full((b, h, t), -torch.inf, device=q.device)
    den = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, HEAD_DIM), device=q.device)
    for k0 in range(0, s, block_k):
        sc = qs @ kh[:, :, k0:k0 + block_k].transpose(-1, -2)
        if variant == "bf16s":
            sc = _bf16(sc)
        alpha = torch.ones_like(m)
        if variant in _MAXED:
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            m = m_new
        if variant == "prod":
            p = torch.exp2(sc - m[..., None])
        elif variant == "nomax":
            p = torch.exp2(sc - NOMAX_SHIFT)
        elif variant == "bf16s":
            p = _bf16(torch.exp2(_bf16(sc - m[..., None])))
        elif variant == "noexp":
            p = sc - m[..., None]
        else:
            p = torch.exp2(torch.clamp(sc - a, min=floor))
        p = p.to(dt).float()
        acc = acc * alpha[..., None] + p @ vh[:, :, k0:k0 + block_k]
        den = den * alpha + p.sum(dim=-1)
    return (acc / den[..., None]).transpose(1, 2).reshape(b, t, inner).to(dt)


def flash_shift_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                       shift: torch.Tensor | None = None, floor: float = SHIFT_CLAMP) -> torch.Tensor:
    """The variant (``flash_probe_kernel``'s full body with the ones-column
    denominator) on contiguous CUDA tensors q (B, T, H·32), k/v (B, S,
    H·32) of one dtype (float32, bfloat16), and for ``bound`` a (B, T, H)
    float32 shift."""
    name = "flash_shift_kernel"
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant {variant!r}: expected one of {VARIANTS}")
    if q.dtype not in KEY_TILE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype, float32 or bfloat16")
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or q.shape[2] % HEAD_DIM):
        raise ValueError(f"{name}: needs q (B, T, H·{HEAD_DIM}) and k, v (B, S, H·{HEAD_DIM}), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, inner = q.shape
    h = inner // HEAD_DIM
    if variant == "bound":
        if shift is None or shift.dtype != torch.float32 or tuple(shift.shape) != (b, t, h):
            raise ValueError(f"{name}: bound needs a ({b}, {t}, {h}) float32 shift")
    elif shift is not None:
        raise ValueError(f"{name}: only the bound variant takes a shift")
    return flash_probe_kernel(q, k, v, "full", variant, True, shift, floor)


def flash_shift(q, k, v, variant, shift=None, floor=SHIFT_CLAMP):
    """The variant on q's device: the plain version on the CPU, the kernel
    on CUDA."""
    if q.device.type == "cpu":
        return flash_shift_plain(q, k, v, variant, shift, floor)
    return flash_shift_kernel(q, k, v, variant, shift, floor)
