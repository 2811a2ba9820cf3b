"""Conditional 1-D UNet denoiser (the SAiD UNet), channels-last, in PyTorch.

Port of ``said_tpu.models.unet1d``: model_channels=192, one ResBlock per
level, no resampling, a spatial transformer (6 heads × 32) at every level
with self-attention, alignment-banded cross-attention to the audio
embedding and a GEGLU feed-forward. Module and parameter names are the reference's torch
names (``input_blocks.1.0.in_layers.0.weight``, …), so a reference
``state_dict`` loads with ``strict=True``. Where the reference's
``nn.Sequential`` puts a SiLU between two parameterised layers, an
``nn.Identity`` keeps the index (the SiLU is fused into the GroupNorm
kernel); its dropouts are ``Dropout`` modules at the same indices.

Train mode: a ``torch.Generator`` passed as ``generator`` turns on the
dropouts (rate ``dropout``, drawn from it) and runs the GEGLU
feed-forward unfused, with dropout between the gate and the output
projection (the JAX ``deterministic=False``); without one the forward is
the deterministic sampling path, the fused GEGLU kernel included. With
``remat`` every ResBlock and spatial transformer is recomputed in the
backward pass (``torch.utils.checkpoint``), its dropout masks drawn
again from the generator state they were first drawn from.

Sequence parallelism (``seq_group``, a ``parallel.mesh.AxisGroup``):
the (B, T/n, ·) activations are this rank's frames of the clip; the k=3
convs take a halo of one frame from the neighbouring ranks, every
GroupNorm joins its statistics across the ranks
(``ops.norms.group_norm_sharded``), self-attention gathers K and V
(``ops.attention.flash_attention_flat_sp``; with a window's real length,
``self_attention`` over them with the window's lengths), and the
cross-attention gathers the context and keeps the band rows of the local
frames; LayerNorm and the GEGLU feed-forward act on each row and run
unchanged. Every collective is differentiable, so a rank's loss on its
frames backpropagates to every rank (training: dropout drawn at the
window's shape and sliced to the rank's frames).

Tensor parallelism (``parallel.tensor.shard_model_``): the attention
layers hold their rank's heads, the feed-forward its block of GEGLU's
(a, g) columns and the timestep MLP its block of hidden units; each of
them takes its input through ``parallel.tensor.enter`` and sums its
row-parallel output over the model axis (the output ``Dense``'s
``reduce_group``), so every other activation is replicated. The
feed-forward's dropout is drawn at the whole width and sliced to the
rank's columns.

Length-bucketed and mixed-length batches (``seq_len_real``): every
GroupNorm is the masked one, pads are zeroed before every k=3 conv and
before the output conv, self-attention masks keys past each row's
length, and the cross-attention band is the dynamic one, so the real
frames equal an unpadded run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from said_tpu_torch.models.layers import Conv1dSame, Dense, Dropout, Frames, GroupNorm32, LayerNormF32
from said_tpu_torch.ops.attention import banded_attention_cached, flash_attention_flat_sp, self_attention
from said_tpu_torch.ops.ffn import geglu_ffn
from said_tpu_torch.ops.masks import alignment_band_dynamic, band_gather_indices
from said_tpu_torch.parallel.seq import gather, sharded
from said_tpu_torch.parallel.tensor import block_draws, enter, reduce

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
    """GN→SiLU→conv, + time embedding, GN→SiLU→dropout→zero-conv, + skip."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.ModuleList(
            [GroupNorm32(in_channels, act="silu"), nn.Identity(), Conv1dSame(in_channels, out_channels, 3)]
        )
        self.emb_layers = nn.ModuleList([nn.Identity(), Dense(emb_channels, out_channels)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(out_channels, act="silu"), nn.Identity(), Dropout(dropout),
             Conv1dSame(out_channels, out_channels, 3)]
        )
        self.skip_connection = (
            Conv1dSame(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor, frames: Optional[Frames] = None,
                generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        lens = None if frames is None else frames.lens(x.shape[0])
        zero = (lambda v: v) if frames is None else frames.zero
        # SAME convs mix neighbours: pads must hold the zero an unpadded
        # run's boundary padding supplies
        h = self.in_layers[2](zero(self.in_layers[0](x, lens, seq_group)), seq_group)
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, None, :].to(h.dtype)
        h = self.out_layers[2](self.out_layers[0](h, lens, seq_group), generator)
        h = self.out_layers[3](zero(h), seq_group)
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class CrossAttention(nn.Module):
    """Multi-head attention: dense self-attention (``context`` None) or
    alignment-banded cross-attention over ``context`` or a K/V cache.
    ``heads`` and ``model_group``: this rank's heads, of a layer sharded
    over a model axis."""

    model_group = None

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, query_dim), Dropout(dropout)])

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        frames: Optional[Frames] = None,
        generator: Optional[torch.Generator] = None,
        seq_group=None,
    ) -> torch.Tensor:
        x = enter(x, self.model_group)
        q = self.to_q(x)
        if kv_cache is not None:
            out = banded_attention_cached(q, *kv_cache, self.heads)
        elif context is None and frames is None and sharded(seq_group):
            out = flash_attention_flat_sp(q, self.to_k(x), self.to_v(x), self.heads, seq_group)
        elif context is None:
            lens = None if frames is None else frames.key_lens(x.shape[0])
            out = self_attention(q, gather(self.to_k(x), seq_group), gather(self.to_v(x), seq_group), self.heads,
                                 lens)
        else:
            context = enter(gather(context, seq_group), self.model_group)
            k, v = self.to_k(context), self.to_v(context)
            real = None if frames is None else frames.host()
            idx, valid = band_tables(x.shape[1], k.shape[1], k.device, real=real, seq_group=seq_group)
            out = banded_attention_cached(q, band_gather(k, idx, self.heads), band_gather(v, idx, self.heads),
                                          valid, self.heads)
        return self.to_out[1](self.to_out[0](out), generator)


def band_tables(x_len: int, c_len: int, device: torch.device, align_pad: int = 1, real=None, seq_group=None):
    """The alignment band for ``x_len`` query frames over ``c_len`` context
    positions, on ``device``: idx (T, W) int64 and valid (T, W) bool; with
    ``real`` (bucketed mode: an int, or (B,) numpy lengths, the same for
    queries and context) the dynamic band, (B, T, W) for per-row lengths.
    With frames sharded over ``seq_group``, ``x_len`` is this rank's share:
    the band of the whole clip (x_len·n frames over the whole context), its
    rows of this rank."""
    n = seq_group.size if sharded(seq_group) else 1
    if real is None:
        idx, valid, _ = band_gather_indices(x_len * n, c_len, align_pad)
    else:
        idx, valid = alignment_band_dynamic(x_len * n, c_len, real, real, align_pad)
    if n > 1:
        rows = slice(seq_group.index * x_len, (seq_group.index + 1) * x_len)
        idx, valid = idx[..., rows, :], valid[..., rows, :]
    return (torch.from_numpy(np.ascontiguousarray(idx).astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(valid)).to(device))


def band_gather(k: torch.Tensor, idx: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Gather the in-band rows of a (B, S, H·D) projection → (B, T, W, H, D);
    ``idx`` (T, W), or (B, T, W) per row."""
    b, s, inner = k.shape
    k4 = k.reshape(b, s, num_heads, inner // num_heads)
    if idx.ndim == 3:
        return k4[torch.arange(b, device=k.device)[:, None, None], idx]
    return k4[:, idx]


class FeedForward(nn.Module):
    """GEGLU feed-forward: the fused GEGLU kernel router, or in train mode
    the unfused form with dropout between the gate and the output
    projection (the JAX ``FeedForward`` with ``deterministic=False``,
    said_tpu/models/unet1d.py:294). Sharded over ``model_group``: the
    projection holds this rank's blocks of a and of g, the kernel runs at
    that width with no output bias, and the bias is added after the sum
    over the ranks."""

    model_group = None

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        inner = dim * mult
        proj = nn.Module()
        proj.proj = Dense(dim, inner * 2)
        self.net = nn.ModuleList([proj, Dropout(dropout), Dense(inner, dim)])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, o = self.net[0].proj, self.net[2]
        group = self.model_group
        x = enter(x, group)
        if generator is None:
            if group is None:
                return geglu_ffn(x, p.weight_as(x.dtype), p.bias, o.weight_as(x.dtype), o.bias)
            y = geglu_ffn(x, p.weight_as(x.dtype), p.bias, o.weight_as(x.dtype), torch.zeros_like(o.bias))
            return reduce(y, group) + o.bias_as(x.dtype)
        h, gate = p(x).chunk(2, dim=-1)
        return o(self.net[1](h * F.gelu(gate), block_draws(generator, 2, h.shape[-1], group)))


class BasicTransformerBlock(nn.Module):
    """Self-attn → alignment-banded cross-attn → GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int, dropout: float = 0.0):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dropout)
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
        generator: Optional[torch.Generator] = None,
        seq_group=None,
    ) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), frames=frames, generator=generator, seq_group=seq_group)
        if cfg_expand:
            # CFG shared-prefix fold: rows [0:B] pair with the uncond half
            # of the K/V cache, [B:2B] with the cond half
            x = torch.cat([x, x])
        x = x + self.attn2(self.norm2(x), context=context, kv_cache=kv_cache, frames=frames, generator=generator,
                           seq_group=seq_group)
        return x + self.ff(self.norm3(x), generator)


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) → transformer blocks → zero 1×1 conv, residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, depth: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, dim_head, dropout) for _ in range(depth)]
        )
        self.proj_out = Conv1dSame(channels, channels, 1)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        kv_cache: Optional[Sequence[KVCache]] = None,
        cfg_expand: bool = False,
        frames: Optional[Frames] = None,
        generator: Optional[torch.Generator] = None,
        seq_group=None,
    ) -> torch.Tensor:
        h = self.norm(x, None if frames is None else frames.lens(x.shape[0]), seq_group)
        for d, block in enumerate(self.transformer_blocks):
            h = block(
                h,
                context=context,
                kv_cache=None if kv_cache is None else kv_cache[d],
                cfg_expand=cfg_expand and d == 0,
                frames=frames,
                generator=generator,
                seq_group=seq_group,
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

    ``dtype`` is the compute dtype; parameters stay float32. ``dropout``
    is the train-mode rate (the JAX package's 0.1); ``remat`` recomputes
    every ResBlock and spatial transformer in the backward pass.
    ``model_group``: the timestep MLP's hidden units are split over a model
    axis (``parallel.tensor``).
    """

    model_group = None

    def __init__(
        self,
        in_channels: int = 32,
        out_channels: int = 32,
        model_channels: int = 192,
        num_head_channels: int = 32,
        cross_attention_dim: int = 768,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.1,
        remat: bool = False,
    ):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        self.num_heads = mc // num_head_channels
        self.dtype = dtype
        self.remat = remat
        heads, dim_head = self.num_heads, mc // self.num_heads
        emb = mc * 4

        def st():
            return SpatialTransformer(mc, cross_attention_dim, heads, dim_head, dropout=dropout)

        def res(c_in):
            return ResBlock1D(c_in, mc, emb, dropout)

        self.time_embed = nn.ModuleList([Dense(mc, emb), nn.Identity(), Dense(emb, emb)])
        self.input_blocks = nn.ModuleList(
            [
                nn.ModuleList([Conv1dSame(in_channels, mc, 3)]),
                nn.ModuleList([res(mc), st()]),
            ]
        )
        self.middle_block = nn.ModuleList([res(mc), st(), res(mc)])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([res(2 * mc), st()]) for _ in range(2)]
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
        generator: Optional[torch.Generator] = None,
        seq_group=None,
    ) -> torch.Tensor:
        """Predict noise. sample (B, T, C_in); timesteps () or (B,);
        context (B, S, cross_attention_dim). Returns (B, T, C_out).

        ``seq_group``: sample, context and the K/V caches hold this rank's
        frames of a clip sharded over it; so does the result. With
        ``seq_len_real`` it counts the real frames of the whole window;
        ``generator`` then draws at the window's shape (a
        ``parallel.mesh.SlicedGenerator`` cut to this rank's frames).

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

        ``generator``: train mode (dropout drawn from it, the unfused
        GEGLU); the K/V-cache fast path and the fold are sampling-only.
        """
        if cfg_fold and kv_caches is None:
            raise ValueError("cfg_fold requires the kv-cache sampling fast path")
        if generator is not None and kv_caches is not None:
            raise ValueError("the kv-cache fast path is sampling-only (no train-mode generator)")
        if cfg_fold and getattr(seq_len_real, "ndim", 0) != 0:
            raise ValueError("cfg_fold supports only one seq_len_real for the batch "
                             "(per-row lengths use the unfolded path)")
        dt = self.dtype
        b, t = sample.shape[:2]
        frames = None
        if seq_len_real is not None:
            offset = seq_group.index * t if sharded(seq_group) else 0
            frames = Frames(seq_len_real, 2 * b if cfg_fold else b, t, sample.device, dt, offset)
        if emb is None:
            t = torch.atleast_1d(torch.as_tensor(timesteps, device=sample.device))
            if t.shape[0] == 1 and b > 1:
                t = t.expand(b)
            e = self.time_embed[0](enter(timestep_embedding(t, self.model_channels).to(dt), self.model_group))
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

        def res(block, h, e):
            return self._block(block, h, e, frames=frames, generator=generator, seq_group=seq_group)

        def st(block, h, name, cfg_expand=False):
            return self._block(block, h, context, kv.get(name), cfg_expand=cfg_expand, frames=frames,
                               generator=generator, seq_group=seq_group)

        h0 = self.input_blocks[0][0](x, seq_group)
        h1 = res(self.input_blocks[1][0], h0, emb)
        h1 = st(self.input_blocks[1][1], h1, "input_attn", cfg_expand=cfg_fold)
        if cfg_fold:
            emb = torch.cat([emb, emb])
            h0 = torch.cat([h0, h0])

        hm = res(self.middle_block[0], h1, emb)
        hm = st(self.middle_block[1], hm, "middle_attn")
        hm = res(self.middle_block[2], hm, emb)

        o = torch.cat([hm, h1], dim=-1)
        o = res(self.output_blocks[0][0], o, emb)
        o = st(self.output_blocks[0][1], o, "output_attn0")
        o = torch.cat([o, h0], dim=-1)
        o = res(self.output_blocks[1][0], o, emb)
        o = st(self.output_blocks[1][1], o, "output_attn1")

        if frames is None:
            o = self.out[0](o, seq_group=seq_group)
        else:
            o = frames.zero(self.out[0](o, frames.lens(o.shape[0]), seq_group))
        o = self.out[2](o, seq_group)
        return o.to(sample.dtype)

    def _block(self, block: nn.Module, *args, generator: Optional[torch.Generator] = None, **kwargs):
        """Run a ResBlock or spatial transformer, under gradient
        checkpointing where ``remat`` is set and a gradient is recorded.

        ``torch.utils.checkpoint`` restores the global RNG for the
        recompute, not an explicit generator: the dropout masks would be
        drawn anew in the backward pass and the gradient would belong to
        other masks. So the generator's state is taken before the block,
        set back at the start of each run of it, and, after the
        recompute, returned to where the rest of the step left it."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(*args, generator=generator, **kwargs)
        if generator is None:
            return checkpoint(lambda *a: block(*a, **kwargs), *args, use_reentrant=False)
        start = generator.get_state()
        runs = []

        def run(*a):
            now = generator.get_state()
            generator.set_state(start)
            try:
                return block(*a, generator=generator, **kwargs)
            finally:  # (the recompute may stop early, by an exception)
                if runs:  # the recompute: leave the generator where it was
                    generator.set_state(now)
                runs.append(True)

        return checkpoint(run, *args, use_reentrant=False)


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
    seq_group=None,
) -> Dict[str, List[KVCache]]:
    """Per-block banded K/V gathers for a fixed context (B, S, E):
    ``{block_name: [(k_win, v_win, valid), ...per depth]}``. With
    ``seq_len_real`` (an int, or (B,) numpy lengths) the band is the
    dynamic one of bucketed mode, gathered per row for (B,) lengths; its
    tables are uploaded once for all blocks. With ``seq_group``, the
    context is this rank's frames of a clip sharded over it and ``x_len``
    its share of the query frames: the context is gathered, and each rank
    keeps the caches of its own frames (the JAX ``_shard_seq_tree``)."""
    context = gather(context.to(unet.dtype), seq_group)
    idx, valid = band_tables(x_len, context.shape[1], context.device, align_pad, seq_len_real, seq_group)
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
