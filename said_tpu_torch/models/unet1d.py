"""Conditional 1-D UNet denoiser (the SAiD UNet), channels-last, in PyTorch.

Port of ``said_tpu.models.unet1d`` for the deterministic (sampling)
path: model_channels=192, one ResBlock per level, no resampling, a
spatial transformer (6 heads × 32) at every level with self-attention,
alignment-banded cross-attention to the audio embedding and a GEGLU
feed-forward. Module and parameter names are the reference's torch
names (``input_blocks.1.0.in_layers.0.weight``, …), so a reference
``state_dict`` loads with ``strict=True``. Where the reference's
``nn.Sequential`` puts a parameter-free layer (SiLU, dropout) between
two parameterised ones, an ``nn.Identity`` keeps the index: the SiLU is
fused into the GroupNorm kernel and sampling runs no dropout.

Length-bucketed and mixed-length batches (``seq_len_real``): every
GroupNorm is the masked one, pads are zeroed before every k=3 conv and
before the output conv, self-attention masks keys past each row's
length, and the cross-attention band is the dynamic one, so the real
frames equal an unpadded run. Not ported yet: remat and training-mode
dropout.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from said_tpu_torch.models.layers import Conv1dSame, Dense, Frames, GroupNorm32, LayerNormF32
from said_tpu_torch.ops.attention import banded_attention_cached, self_attention
from said_tpu_torch.ops.ffn import geglu_ffn
from said_tpu_torch.ops.masks import alignment_band_dynamic, band_gather_indices

KVCache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, cosine components first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ResBlock1D(nn.Module):
    """GN→SiLU→conv, + time embedding, GN→SiLU→zero-conv, + skip."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int):
        super().__init__()
        self.in_layers = nn.ModuleList(
            [GroupNorm32(in_channels, act="silu"), nn.Identity(), Conv1dSame(in_channels, out_channels, 3)]
        )
        self.emb_layers = nn.ModuleList([nn.Identity(), Dense(emb_channels, out_channels)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(out_channels, act="silu"), nn.Identity(), nn.Identity(),
             Conv1dSame(out_channels, out_channels, 3)]
        )
        self.skip_connection = (
            Conv1dSame(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor, frames: Optional[Frames] = None) -> torch.Tensor:
        lens = None if frames is None else frames.lens(x.shape[0])
        zero = (lambda v: v) if frames is None else frames.zero
        # SAME convs mix neighbours: pads must hold the zero an unpadded
        # run's boundary padding supplies
        h = self.in_layers[2](zero(self.in_layers[0](x, lens)))
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, None, :].to(h.dtype)
        h = self.out_layers[3](zero(self.out_layers[0](h, lens)))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class CrossAttention(nn.Module):
    """Multi-head attention: dense self-attention (``context`` None) or
    alignment-banded cross-attention over ``context`` or a K/V cache."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, query_dim)])

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        frames: Optional[Frames] = None,
    ) -> torch.Tensor:
        q = self.to_q(x)
        if kv_cache is not None:
            out = banded_attention_cached(q, *kv_cache, self.heads)
        elif context is None:
            lens = None if frames is None else frames.lens(x.shape[0])
            out = self_attention(q, self.to_k(x), self.to_v(x), self.heads, lens)
        else:
            k, v = self.to_k(context), self.to_v(context)
            real = None if frames is None else frames.host()
            idx, valid = band_tables(x.shape[1], k.shape[1], k.device, real=real)
            out = banded_attention_cached(q, band_gather(k, idx, self.heads), band_gather(v, idx, self.heads),
                                          valid, self.heads)
        return self.to_out[0](out)


def band_tables(x_len: int, c_len: int, device: torch.device, align_pad: int = 1, real=None):
    """The alignment band for ``x_len`` query frames over ``c_len`` context
    positions, on ``device``: idx (T, W) int64 and valid (T, W) bool; with
    ``real`` (bucketed mode: an int, or (B,) numpy lengths, the same for
    queries and context) the dynamic band, (B, T, W) for per-row lengths."""
    if real is None:
        idx, valid, _ = band_gather_indices(x_len, c_len, align_pad)
    else:
        idx, valid = alignment_band_dynamic(x_len, c_len, real, real, align_pad)
    return torch.from_numpy(idx.astype(np.int64)).to(device), torch.from_numpy(valid).to(device)


def band_gather(k: torch.Tensor, idx: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Gather the in-band rows of a (B, S, H·D) projection → (B, T, W, H, D);
    ``idx`` (T, W), or (B, T, W) per row."""
    b, s, inner = k.shape
    k4 = k.reshape(b, s, num_heads, inner // num_heads)
    if idx.ndim == 3:
        return k4[torch.arange(b, device=k.device)[:, None, None], idx]
    return k4[:, idx]


class FeedForward(nn.Module):
    """GEGLU feed-forward through the fused GEGLU kernel router."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        proj = nn.Module()
        proj.proj = Dense(dim, inner * 2)
        self.net = nn.ModuleList([proj, nn.Identity(), Dense(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, o = self.net[0].proj, self.net[2]
        return geglu_ffn(x, p.weight_as(x.dtype), p.bias, o.weight_as(x.dtype), o.bias)


class BasicTransformerBlock(nn.Module):
    """Self-attn → alignment-banded cross-attn → GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.norm3 = LayerNormF32(dim)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        cfg_expand: bool = False,
        frames: Optional[Frames] = None,
    ) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), frames=frames)
        if cfg_expand:
            # CFG shared-prefix fold: rows [0:B] pair with the uncond half
            # of the K/V cache, [B:2B] with the cond half
            x = torch.cat([x, x])
        x = x + self.attn2(self.norm2(x), context=context, kv_cache=kv_cache, frames=frames)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) → transformer blocks → zero 1×1 conv, residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, dim_head) for _ in range(depth)]
        )
        self.proj_out = Conv1dSame(channels, channels, 1)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        kv_cache: Optional[Sequence[KVCache]] = None,
        cfg_expand: bool = False,
        frames: Optional[Frames] = None,
    ) -> torch.Tensor:
        h = self.norm(x, None if frames is None else frames.lens(x.shape[0]))
        for d, block in enumerate(self.transformer_blocks):
            h = block(
                h,
                context=context,
                kv_cache=None if kv_cache is None else kv_cache[d],
                cfg_expand=cfg_expand and d == 0,
                frames=frames,
            )
        h = self.proj_out(h)
        if cfg_expand:
            x = torch.cat([x, x])
        return h + x


class UNet1DConditionModel(nn.Module):
    """The SAiD denoiser: a no-resampling 1-D UNet with cross-attention.

        in-conv(32→192)
        → [ResBlock, SpatialTransformer]                 (input block)
        → [ResBlock, SpatialTransformer, ResBlock]       (middle)
        → 2 × [ResBlock(skip-concat 384→192), SpatialTransformer]
        → GroupNorm → SiLU → zero-conv(192→32)

    ``dtype`` is the compute dtype; parameters stay float32.
    """

    def __init__(
        self,
        in_channels: int = 32,
        out_channels: int = 32,
        model_channels: int = 192,
        num_head_channels: int = 32,
        cross_attention_dim: int = 768,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        self.num_heads = mc // num_head_channels
        self.dtype = dtype
        heads, dim_head = self.num_heads, mc // self.num_heads
        emb = mc * 4

        def st():
            return SpatialTransformer(mc, cross_attention_dim, heads, dim_head)

        self.time_embed = nn.ModuleList([Dense(mc, emb), nn.Identity(), Dense(emb, emb)])
        self.input_blocks = nn.ModuleList(
            [
                nn.ModuleList([Conv1dSame(in_channels, mc, 3)]),
                nn.ModuleList([ResBlock1D(mc, mc, emb), st()]),
            ]
        )
        self.middle_block = nn.ModuleList([ResBlock1D(mc, mc, emb), st(), ResBlock1D(mc, mc, emb)])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([ResBlock1D(2 * mc, mc, emb), st()]) for _ in range(2)]
        )
        self.out = nn.ModuleList(
            [GroupNorm32(mc, act="silu"), nn.Identity(), Conv1dSame(mc, out_channels, 3)]
        )

    def spatial_transformers(self) -> List[Tuple[str, SpatialTransformer]]:
        """The four spatial transformers, under their JAX parameter names
        (the keys of ``kv_caches``)."""
        return [
            ("input_attn", self.input_blocks[1][1]),
            ("middle_attn", self.middle_block[1]),
            ("output_attn0", self.output_blocks[0][1]),
            ("output_attn1", self.output_blocks[1][1]),
        ]

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: Optional[torch.Tensor] = None,
        context: Optional[torch.Tensor] = None,
        kv_caches: Optional[Dict[str, List[KVCache]]] = None,
        emb: Optional[torch.Tensor] = None,
        cfg_fold: bool = False,
        seq_len_real=None,
    ) -> torch.Tensor:
        """Predict noise. sample (B, T, C_in); timesteps () or (B,);
        context (B, S, cross_attention_dim). Returns (B, T, C_out).

        Sampling fast path: ``kv_caches`` (``build_kv_caches``) and a
        precomputed ``emb`` (a row of ``time_embed_table``) replace the
        loop-invariant context projections and the timestep MLP.

        ``cfg_fold``: the caller passes the un-duplicated latent (B, T, C)
        while ``kv_caches`` hold the CFG-doubled context (uncond first);
        everything up to the first cross-attention runs once at batch B
        and the batch doubles there. Returns (2B, T, C_out).

        Length-bucketed mode: ``seq_len_real`` is how many of the T frames
        are real, an int or (B,) lengths (numpy, or an int tensor on the
        device, which is then not copied); the real frames equal an
        unpadded run. The fold takes only an int.
        """
        if cfg_fold and kv_caches is None:
            raise ValueError("cfg_fold requires the kv-cache sampling fast path")
        if cfg_fold and getattr(seq_len_real, "ndim", 0) != 0:
            raise ValueError("cfg_fold supports only one seq_len_real for the batch "
                             "(per-row lengths use the unfolded path)")
        dt = self.dtype
        b = sample.shape[0]
        frames = None
        if seq_len_real is not None:
            frames = Frames(seq_len_real, 2 * b if cfg_fold else b, sample.shape[1], sample.device, dt)
        if emb is None:
            t = torch.atleast_1d(torch.as_tensor(timesteps, device=sample.device))
            if t.shape[0] == 1 and b > 1:
                t = t.expand(b)
            e = self.time_embed[0](timestep_embedding(t, self.model_channels).to(dt))
            emb = self.time_embed[2](F.silu(e))
        else:
            emb = emb.to(dt)
            if emb.ndim == 1:
                emb = emb[None, :].expand(b, -1)

        kv = kv_caches or {}
        x = sample.to(dt)
        if frames is not None:
            x = frames.zero(x)
        if context is not None:
            context = context.to(dt)

        h0 = self.input_blocks[0][0](x)
        h1 = self.input_blocks[1][0](h0, emb, frames=frames)
        h1 = self.input_blocks[1][1](h1, context, kv.get("input_attn"), cfg_expand=cfg_fold, frames=frames)
        if cfg_fold:
            emb = torch.cat([emb, emb])
            h0 = torch.cat([h0, h0])

        hm = self.middle_block[0](h1, emb, frames=frames)
        hm = self.middle_block[1](hm, context, kv.get("middle_attn"), frames=frames)
        hm = self.middle_block[2](hm, emb, frames=frames)

        o = torch.cat([hm, h1], dim=-1)
        o = self.output_blocks[0][0](o, emb, frames=frames)
        o = self.output_blocks[0][1](o, context, kv.get("output_attn0"), frames=frames)
        o = torch.cat([o, h0], dim=-1)
        o = self.output_blocks[1][0](o, emb, frames=frames)
        o = self.output_blocks[1][1](o, context, kv.get("output_attn1"), frames=frames)

        if frames is None:
            o = self.out[0](o)
        else:
            o = frames.zero(self.out[0](o, frames.lens(o.shape[0])))
        o = self.out[2](o)
        return o.to(sample.dtype)


# ---------------------------------------------------------------------------
# Sampling fast-path helpers: everything in the denoise loop that depends on
# neither the latent nor the timestep.


@torch.no_grad()
def build_kv_caches(
    unet: UNet1DConditionModel,
    context: torch.Tensor,
    x_len: int,
    align_pad: int = 1,
    seq_len_real=None,
) -> Dict[str, List[KVCache]]:
    """Per-block banded K/V gathers for a fixed context (B, S, E):
    ``{block_name: [(k_win, v_win, valid), ...per depth]}``. With
    ``seq_len_real`` (an int, or (B,) numpy lengths) the band is the
    dynamic one of bucketed mode, gathered per row for (B,) lengths; its
    tables are uploaded once for all blocks."""
    context = context.to(unet.dtype)
    idx, valid = band_tables(x_len, context.shape[1], context.device, align_pad, seq_len_real)
    caches = {}
    for name, st in unet.spatial_transformers():
        caches[name] = [
            (band_gather(blk.attn2.to_k(context), idx, unet.num_heads),
             band_gather(blk.attn2.to_v(context), idx, unet.num_heads), valid)
            for blk in st.transformer_blocks
        ]
    return caches


@torch.no_grad()
def time_embed_table(unet: UNet1DConditionModel, timesteps: np.ndarray) -> torch.Tensor:
    """The timestep MLP for a whole grid at once, in float32 → (K, 4·mc);
    the sampling loop indexes it instead of re-running the MLP per step."""
    w = next(unet.parameters())
    t = torch.as_tensor(np.atleast_1d(timesteps), device=w.device)
    t_emb = timestep_embedding(t, unet.model_channels)
    l0, l2 = unet.time_embed[0], unet.time_embed[2]
    h = F.silu(F.linear(t_emb, l0.weight, l0.bias))
    return F.linear(h, l2.weight, l2.bias)
