"""Multi-head attention on flat (B, T, H·D) projections, f32 softmax.

Port of ``said_tpu.ops.attention`` (the banded cross-attention over
pre-gathered keys, ``banded_attention_cached``, and the dense branch of
``multi_head_attention``) and of the self-attention router
``flash_attention_flat`` / ``_flash_route``
(said_tpu/ops/pallas_attention.py:746, :580), here ``self_attention``:

- T and S ≤ ``DENSE_MAX`` (2048 frames): dense, on any device, with a
  key mask where (B,) lengths are given (``_dense_reference``, :66); the
  JAX package runs these as plain einsums even on the TPU;
- longer, on the CPU: ``flash_attention_plain``;
- longer, on CUDA: ``flash_attention_kernel``, the hand-written kernel
  ``csrc/flash_attention.cu``, which replaces both TPU kernels
  ``_flash_tpu_packed`` (:186, K1) and ``_flash_tpu_packed_blocked``
  (:322, K2); its source note says what bounds it and how it is laid
  out. Any other device raises.

Gradients: the dense path is plain PyTorch; past ``DENSE_MAX`` the router
runs as ``_FlashAttentionFn`` (forward as above) whose backward,
``attention_backward``, recomputes the scores (the JAX ``_attn_bwd_route``,
:734): every key at once up to ``BWD_DENSE_MAX`` keys, in
``BWD_BLOCK_K``-key blocks beyond, never a (T, S) tensor past 4096 keys.

Sequence parallelism: ``flash_attention_flat_sp`` keeps Q frame-sharded
and gathers K and V, then routes as above. The gathers are
differentiable (``parallel.seq.gather``), so the gradient of a rank's
queries against the gathered keys is ``_FlashAttentionFn``'s, and dk, dv
are summed over the ranks in rank order and sliced back to the rank's
frames by the gathers' backward. Sequence-parallel training with a
window's real length takes ``self_attention`` over the gathered K and V
with the window's lengths: dense up to ``DENSE_MAX`` gathered keys (the
JAX package's dense key-masked route under ``flash_sp``), K1 with lengths
beyond; the kernel masks keys by their index in the gathered K/V and
zeroes only query rows whose index in the rank's block is past the
length, each of them a padded frame, whose gradient is 0.

Nothing catches a kernel failure to fall back. The TPU router's VMEM
thresholds (``_fullk_smax``, ``_blocked_blocks``) have no counterpart:
the one kernel streams any key length.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from said_tpu_torch import _build
from said_tpu_torch.ops import needs_grad
from said_tpu_torch.parallel.seq import gather

_NEG_INF = float(torch.finfo(torch.float32).max)

# Longest self-attention (frames) the dense path serves; the JAX
# router's ``_DENSE_MAX`` (said_tpu/ops/pallas_attention.py:522).
DENSE_MAX = 2048
_LOG2E = math.log2(math.e)
# keys per step of the plain version's loop: its scores are (B, H, T, 512)
_PLAIN_BLOCK_K = 512
_HEAD_DIMS = (32, 64)


def _softmax_f32(scores: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1).to(out_dtype)


def banded_attention_cached(
    q: torch.Tensor,
    k_win: torch.Tensor,
    v_win: torch.Tensor,
    valid: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Banded cross-attention with pre-gathered keys/values.

    q (B, T, H·D); k_win/v_win (B, T, W, H, D); valid (T, W) bool, or
    (B, T, W) for per-row bands (mixed-length batches).
    """
    b, t, inner = q.shape
    d = inner // num_heads
    qh = q.reshape(b, t, num_heads, d)
    scores = torch.einsum("bthd,btwhd->bhtw", qh, k_win) * d**-0.5
    vmask = valid[:, None] if valid.ndim == 3 else valid[None, None]
    # masked in f32: -finfo(f32).max does not fit bf16
    scores = scores.float().masked_fill(~vmask, -_NEG_INF)
    attn = _softmax_f32(scores, qh.dtype)
    out = torch.einsum("bhtw,btwhd->bthd", attn, v_win)
    return out.reshape(b, t, inner)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    lengths: torch.Tensor | None = None,
    probs: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Materialized-scores attention: q (B, T, H·D), k/v (B, S, H·D);
    keys at or past a row's ``lengths`` entry (B,) are masked. ``probs``,
    if given, maps the (B, H, T, S) probabilities before the product with
    v (the encoder's train-mode dropout)."""
    b, t, inner = q.shape
    s = k.shape[1]
    d = inner // num_heads
    qh = q.reshape(b, t, num_heads, d)
    kh = k.reshape(b, s, num_heads, d)
    vh = v.reshape(b, s, num_heads, d)
    scores = torch.einsum("bthd,bshd->bhts", qh, kh) * d**-0.5
    if lengths is not None:
        keymask = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        scores = scores.masked_fill(~keymask[:, None, None, :], -math.inf)
    attn = _softmax_f32(scores, qh.dtype)
    if probs is not None:
        attn = probs(attn)
    out = torch.einsum("bhts,bshd->bthd", attn, vh)
    return out.reshape(b, t, inner)


def _q_scale(d: int) -> float:
    """d^-1/2 · log2(e) as the float32 the kernels multiply Q by."""
    return float(torch.tensor(d**-0.5 * _LOG2E, dtype=torch.float32))


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the flash kernel, with its numerics: q (B, T, H·D),
    k/v (B, S, H·D), optional (B,) lengths.

    A key-blocked online softmax: Q scaled by d^-1/2 · log2(e) in f32 and
    rounded to the input dtype, f32 scores, p = exp2(s − running max)
    rounded to V's dtype before the PV product and the sum, f32 state, one
    division at the end. Keys at or past a row's length are masked, query
    rows at or past it are 0, a length-0 row is 0. Memory O(B·H·T·512).
    """
    b, t, inner = q.shape
    s = k.shape[1]
    h = num_heads
    d = inner // h
    dt = q.dtype
    qh = (q.float() * _q_scale(d)).to(dt).float().reshape(b, t, h, d).transpose(1, 2)
    kh = k.float().reshape(b, s, h, d).transpose(1, 2)
    vh = v.float().reshape(b, s, h, d).transpose(1, 2)
    m = torch.full((b, h, t), -math.inf, device=q.device)
    denom = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    lens = None
    if lengths is not None:
        lens = lengths.to(device=q.device, dtype=torch.int64).clamp(min=0)
    # every key block, also those wholly past every length: their p is 0 and
    # their alpha 1, so they change nothing, and no host sync reads lengths
    for k0 in range(0, s, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, s)
        sc = qh @ kh[:, :, k0:k1].transpose(-1, -2)  # (b, h, t, block) f32
        if lens is not None:
            col = torch.arange(k0, k1, device=q.device)
            sc = sc.masked_fill(col[None, None, None, :] >= lens[:, None, None, None], -math.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # m_new = -inf: every key so far masked; keep the zero state
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
        p = torch.where(sc == -math.inf, 0.0, torch.exp2(sc - m_new[..., None]))
        p = p.to(dt).float()
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vh[:, :, k0:k1]
        m = m_new
    live = denom > 0
    if lens is not None:
        live = live & (torch.arange(t, device=q.device)[None, None, :] < lens[:, None, None])
    out = torch.where(live[..., None], acc / torch.where(live, denom, 1.0)[..., None], 0.0)
    return out.transpose(1, 2).reshape(b, t, inner).to(dt)


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch ``said_flash_attention`` on contiguous CUDA tensors q
    (B, T, H·D) and k/v (B, S, H·D) of one dtype (float32 or bfloat16),
    head dim D ∈ {32, 64}; ``lengths``, if given, a contiguous (B,) int32
    tensor on the same device."""
    name = "flash_attention_kernel"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got device {q.device}")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: needs q (B, T, H·D) and k, v (B, S, H·D) of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, inner = q.shape
    s = k.shape[1]
    if k.shape[0] != b or k.shape[2] != inner or t == 0 or s == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} do not pair")
    if num_heads <= 0 or inner % num_heads or inner // num_heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim must be one of {_HEAD_DIMS}, got {inner} / {num_heads} heads")
    for key, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: {key} is {x.dtype} on {x.device}, q is {q.dtype} on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on a 16-byte boundary (the kernel copies 16-byte rows)")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {q.device}, not the current device")
    lens_ptr = None
    if lengths is not None:
        if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,)
                or lengths.device != q.device or not lengths.is_contiguous()):
            raise ValueError(f"{name}: lengths must be a contiguous ({b},) int32 tensor on {q.device}, "
                             f"got {lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
        lens_ptr = lengths.data_ptr()
    out = torch.empty_like(q)
    err = _build.library().said_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens_ptr,
        b, t, s, num_heads, inner // num_heads, _build.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


class _FlashAttentionFn(torch.autograd.Function):
    """Self-attention past ``DENSE_MAX`` frames with a gradient: the
    router's forward (the kernel on CUDA, the plain version on the CPU),
    ``attention_backward`` for the gradient; saves q, k, v, the output and
    the lengths, never a (T, S) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, lengths):
        out = _flash_route(q, k, v, num_heads, lengths)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, out, lengths)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lengths = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, g, ctx.num_heads, lengths)
        return dq, dk, dv, None, None


def _flash_route(q, k, v, num_heads, lengths):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, lengths)
    return flash_attention_kernel(q, k, v, num_heads, lengths)


def self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Router for self-attention (the JAX ``flash_attention_flat`` /
    ``_flash_route``), with optional (B,) int32 real lengths on q's device:
    dense up to ``DENSE_MAX`` frames on any device (differentiable as plain
    PyTorch); beyond, the plain flash version on the CPU and the flash
    kernel on any other device (which raises unless it is CUDA), through
    ``_FlashAttentionFn`` where an input needs a gradient."""
    if max(q.shape[1], k.shape[1]) <= DENSE_MAX:
        return dense_attention(q, k, v, num_heads, lengths)
    if needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, num_heads, lengths)
    return _flash_route(q, k, v, num_heads, lengths)


def flash_attention_flat_sp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    group=None,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Frame-sharded (sequence-parallel) self-attention, the JAX
    ``flash_attention_flat_sp`` / ``_sp_flash``
    (said_tpu/ops/pallas_attention.py:784-876): q, k, v are this rank's
    (B, T/n, H·D) frames of a clip sharded over ``group`` (a
    ``parallel.mesh.AxisGroup``); Q stays sharded, K and V are all-gathered
    along frames, and the local call is ``_flash_route`` with T_q = T/n and
    S = T (on the card the flash kernel, on the CPU its plain version). The
    output is this rank's frames. With no group, or a group of one rank,
    it is ``self_attention``, as in JAX. No runtime lengths (SP serves one
    long clip, not mixed-length buckets). Differentiable, as the JAX
    ``_flash_sp_bwd``: ``_FlashAttentionFn`` of the local queries over the
    gathered K and V, whose gradients the gathers sum over the ranks."""
    if lengths is not None:
        raise ValueError("flash_sp does not support runtime lengths")
    if group is None or group.size == 1:
        return self_attention(q, k, v, num_heads)
    k, v = gather(k, group), gather(v, group)
    if needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, num_heads, None)
    return _flash_route(q, k, v, num_heads, None)


# ------------------------------------------------------------- backward

# Backward routing (the JAX ``_attn_bwd_route``,
# said_tpu/ops/pallas_attention.py:734): up to BWD_DENSE_MAX keys the
# dense recompute, every key's score of a row at once; beyond, the
# blockwise backward in BWD_BLOCK_K-key blocks, whose memory is
# O(T · block) (``_BWD_DENSE_MAX``, ``_BWD_BLOCK_K``, :613-614).
BWD_DENSE_MAX = 4096
BWD_BLOCK_K = 1024


def attention_backward(q, k, v, out, g, num_heads, lengths=None):
    """(dq, dk, dv) of attention over flat (B, T, H·D) projections for the
    output gradient g: ``chunked_attention_backward`` with one block of all
    keys (the dense recompute) up to ``BWD_DENSE_MAX`` keys, in blocks of
    ``BWD_BLOCK_K`` beyond. One function for both, so bf16 keeps bf16
    operands with f32 accumulation and f32 softmax statistics on both
    routes (the JAX dense route differentiates bf16 einsums instead)."""
    s = k.shape[1]
    block_k = s if s <= BWD_DENSE_MAX else BWD_BLOCK_K
    return chunked_attention_backward(q, k, v, out, g, num_heads, lengths, block_k=block_k)


def chunked_attention_backward(q, k, v, out, g, num_heads, lengths=None, block_k=None):
    """The blockwise attention backward (the JAX ``_chunked_attn_bwd``,
    said_tpu/ops/pallas_attention.py:617): scores recomputed a block of
    ``block_k`` keys at a time, twice: once for each row's log-sum-exp,
    once for dq, dk and dv by the flash identities ds = p ⊙ (dp − δ),
    δ = rowsum(g ⊙ out). Memory O(B·H·T·block_k); no (T, S) tensor.

    Numerics as the JAX function: bf16 inputs keep bf16 operands with f32
    accumulation (here: operands rounded to bf16, then multiplied in f32,
    so every product is exact and every sum f32) and f32 softmax
    statistics; f32 inputs are f32 throughout. Keys at or past a row's
    length are masked."""
    in_dtype = q.dtype
    b, t, inner = q.shape
    s = k.shape[1]
    h = num_heads
    d = inner // h
    scale = d**-0.5
    block_k = block_k or BWD_BLOCK_K

    def heads(x, n):  # (B, n, H·D) -> (B, H, n, D), f32 of the working-type operand
        return x.to(torch.bfloat16 if in_dtype == torch.bfloat16 else torch.float32).float().reshape(
            b, n, h, d).transpose(1, 2)

    qh, gh, kh, vh = heads(q, t), heads(g, t), heads(k, s), heads(v, s)
    # delta subtracts from dp: f32 elementwise from the unrounded values
    delta = (g.float() * out.float()).reshape(b, t, h, d).sum(dim=-1).transpose(1, 2)  # (B, H, T)
    lens = None if lengths is None else lengths.to(device=q.device, dtype=torch.int64)

    def block_scores(k0, k1):
        sc = (qh @ kh[:, :, k0:k1].transpose(-1, -2)) * scale  # (B, H, T, block) f32
        if lens is not None:
            col = torch.arange(k0, k1, device=q.device)
            sc = sc.masked_fill(col[None, None, None, :] >= lens[:, None, None, None], -math.inf)
        return sc

    blocks = [(k0, min(k0 + block_k, s)) for k0 in range(0, s, block_k)]
    m = torch.full((b, h, t), -math.inf, device=q.device)
    lsum = torch.zeros((b, h, t), device=q.device)
    for k0, k1 in blocks:
        sc = block_scores(k0, k1)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # m_new = -inf: every key so far masked; the sum stays 0
        safe = torch.where(m_new == -math.inf, 0.0, m_new)
        lsum = lsum * torch.exp(m - safe) + torch.exp(sc - safe[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(lsum)

    rnd = (lambda x: x.to(torch.bfloat16).float()) if in_dtype == torch.bfloat16 else (lambda x: x)
    dq = torch.zeros((b, h, t, d), device=q.device)
    dk, dv = [], []
    for k0, k1 in blocks:
        p = torch.exp(block_scores(k0, k1) - lse[..., None])
        dv.append(rnd(p).transpose(-1, -2) @ gh)
        dp = gh @ vh[:, :, k0:k1].transpose(-1, -2)
        ds = rnd(p * (dp - delta[..., None]) * scale)
        dq = dq + ds @ kh[:, :, k0:k1]
        dk.append(ds.transpose(-1, -2) @ qh)

    def flat(x, n):
        return x.transpose(1, 2).reshape(b, n, inner).to(in_dtype)

    return flat(dq, t), flat(torch.cat(dk, dim=2), s), flat(torch.cat(dv, dim=2), s)
