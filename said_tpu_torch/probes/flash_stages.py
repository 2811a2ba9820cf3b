"""K1 cut open one softmax stage at a time (probes P1 and P2).

Port of the Pallas probes ``tools/attn_probe.py::build`` (:29, the
per-head layout (B·H, T, D)) and ``tools/attn_probe2.py::
packed_kernel_factory`` (:33, the packed layout (B, T, H·D)), both as
the stage knob of ``csrc/probes/flash_probe.cu`` (its source note says
what each stage keeps and what bounds it). ``flash_stages`` routes: the
plain version on the CPU, the kernel on CUDA (which raises on what it
does not take).

The partial stages (qk … qk_max_exp_sum) are defined per key block: the
first D score or probability columns of every block, summed, and a
running max without rescale, as the JAX stages define them. So the plain
version takes the key block; the kernel's is ``KEY_TILE`` (128 keys in
bf16, 64 in f32), and on the card the two are compared at that block.
"""

from __future__ import annotations

import math

import torch

from said_tpu_torch.probes import HEAD_DIM
from said_tpu_torch.probes.flash_probe import KEY_TILE, ROW_TILE, STAGES, flash_probe_kernel
from said_tpu_torch.probes.shift import fold_q

LAYOUTS = ("head", "packed")
_LN2 = math.log(2.0)


def _heads(x: torch.Tensor, layout: str) -> torch.Tensor:
    """(N, T, D) f32 from either layout (N = B·H)."""
    if layout == "head":
        return x.float()
    b, t, inner = x.shape
    return x.float().reshape(b, t, inner // HEAD_DIM, HEAD_DIM).transpose(1, 2).reshape(-1, t, HEAD_DIM)


def _unheads(x: torch.Tensor, like: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "head":
        return x.to(like.dtype)
    b, t, inner = like.shape
    return x.reshape(b, inner // HEAD_DIM, t, HEAD_DIM).transpose(1, 2).reshape(b, t, inner).to(like.dtype)


def flash_stages_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stage: str, layout: str = "head",
                       block_k: int | None = None) -> torch.Tensor:
    """Plain version of the stage kernel with its numerics, over key blocks
    of ``block_k`` (default the kernel's tile): Q scaled by d^-1/2·log2 e in
    f32 and rounded to its dtype, f32 scores s (exp2 units), running max
    m, p = exp2(s − m), f32 state; full rounds p to V's dtype before PV and
    the sum. Outputs: copy q; qk Σ s[:, :D]·ln 2; qk_max m·ln 2; qk_max_exp
    Σ p[:, :D]; qk_max_exp_sum that / l; full softmax attention."""
    if stage not in STAGES or layout not in LAYOUTS:
        raise ValueError(f"stage {stage!r} / layout {layout!r}: expected one of {STAGES} / {LAYOUTS}")
    if stage == "copy":
        return q.clone()
    dt = q.dtype
    block_k = block_k or KEY_TILE[dt]
    qs = _heads(fold_q(q), layout)
    kh, vh = _heads(k, layout), _heads(v, layout)
    n, t, d = qs.shape
    m = torch.full((n, t), -math.inf, device=q.device)
    l = torch.zeros((n, t), device=q.device)
    acc = torch.zeros((n, t, d), device=q.device)
    for k0 in range(0, kh.shape[1], block_k):
        sc = qs @ kh[:, k0:k0 + block_k].transpose(1, 2)
        if stage == "qk":
            acc += sc[..., :d]
            continue
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        m = m_new
        if stage == "qk_max":
            continue
        p = torch.exp2(sc - m_new[..., None])
        if stage != "full":
            acc += p[..., :d]
            if stage == "qk_max_exp_sum":
                l = l * alpha + p.sum(dim=-1)
            continue
        p = p.to(dt).float()
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vh[:, k0:k0 + block_k]
    if stage == "qk":
        out = acc * _LN2
    elif stage == "qk_max":
        out = (m * _LN2)[..., None].expand(n, t, d)
    elif stage == "qk_max_exp":
        out = acc
    else:
        out = acc / l[..., None]
    return _unheads(out, q, layout)


def _check_shapes(name, q, k, v, stage, layout):
    if stage not in STAGES or layout not in LAYOUTS:
        raise ValueError(f"{name}: stage {stage!r} / layout {layout!r}: expected one of {STAGES} / {LAYOUTS}")
    if q.dtype not in KEY_TILE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not pair")
    if (q.shape[2] != HEAD_DIM) if layout == "head" else (q.shape[2] % HEAD_DIM):
        raise ValueError(f"{name}: the {layout} layout needs rows of {'' if layout == 'head' else 'H·'}{HEAD_DIM}, "
                         f"got {q.shape[2]}")
    if any(x.dtype != q.dtype for x in (k, v)):
        raise ValueError(f"{name}: q, k and v must share a dtype")


def flash_stages_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stage: str,
                        layout: str = "head") -> torch.Tensor:
    """The stage kernel (``flash_probe_kernel`` cut at ``stage``, K1's
    register denominator) on contiguous CUDA tensors q (B·H, T, 32) /
    (B, T, H·32) and k, v of S keys, one dtype (float32, bfloat16); T a
    multiple of 64, S of the key tile."""
    name = "flash_stages_kernel"
    _check_shapes(name, q, k, v, stage, layout)
    t, s = q.shape[1], k.shape[1]
    if t % ROW_TILE or s % KEY_TILE[q.dtype]:
        raise ValueError(f"{name}: T = {t} must be a multiple of {ROW_TILE} and S = {s} of the key tile "
                         f"{KEY_TILE[q.dtype]}")
    return flash_probe_kernel(q, k, v, stage)


def flash_stages(q, k, v, stage, layout="head", block_k=None):
    """The stage on q's device: the plain version (at ``block_k``, default
    the kernel's tile) on the CPU, the kernel on CUDA, where ``block_k``
    must be the kernel's tile or None."""
    if q.device.type == "cpu":
        return flash_stages_plain(q, k, v, stage, layout, block_k)
    if block_k not in (None, KEY_TILE.get(q.dtype)):
        raise ValueError(f"flash_stages: the kernel's key tile is {KEY_TILE.get(q.dtype)}, not {block_k}")
    return flash_stages_kernel(q, k, v, stage, layout)
