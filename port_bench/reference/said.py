"""SAiD in plain PyTorch, float32: the benchmark's reference.

Park et al., "SAiD: Speech-driven Blendshape Facial Animation with
Diffusion" (arXiv:2401.08655; github.com/yunik1004/SAiD): a wav2vec2-base
audio encoder (HF ``facebook/wav2vec2-base-960h``: a 7-layer strided conv
feature extractor, its features interpolated (align corners) to the
60 fps frame count, a weight-normed grouped positional conv and 12
post-norm transformer layers of 12 × 64 heads) conditions a 1-D UNet of
192 channels (one ResBlock a level, no resampling, a spatial transformer
of 6 × 32 heads at every level: self-attention, cross-attention to the
audio embedding restricted to an alignment band, a GEGLU feed-forward).

Written from that description with ``torch.nn.functional`` alone, under
the reference's ``state_dict`` names, so the benchmark hands one set of
weights to this model and to the program. No kernel, cache or batching
trick: the cross-attention gathers each frame's band of keys every call,
self-attention materialises its scores one block of queries at a time
(exact softmax over every key), and nothing is shared between the CFG
halves. Departures from the published code, each numerically neutral:
the band is gathered rather than masked (the same keys), convolutions
are a product a tap, and the interpolation forms its coordinates in
float64.

``precision`` says how every product is computed: "f32" (TF32 off),
"tf32" (cuBLAS and cuDNN in TF32, the control below f32), "bf16" or
"fp8" (every operand of a product rounded to bfloat16, or to float8
e4m3 with a per-tensor scale, and multiplied in float32: the controls
below float32 and bfloat16).

Train mode (``generator`` passed) draws dropout, layerdrop and the
attention-probability dropout from that generator in the order the
published module runs them, each at the padded shape a bucketed batch
has (``frames_pad``) and cut to the real frames, so a run of the same
batch with the same seed sees the same numbers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3


class Precision:
    """Rounds the operands of every product, by mode."""

    MODES = ("f32", "tf32", "bf16", "fp8")

    def __init__(self, mode: str = "f32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r} is not one of {self.MODES}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        if self.mode == "fp8":
            scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x

    @contextlib.contextmanager
    def backend(self):
        """TF32 on for "tf32", off otherwise, for the block; restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Draws:
    """Train-mode randomness: each array drawn at its padded shape from
    ``generator`` and cut to the real one."""

    def __init__(self, generator: Optional[torch.Generator], frames_pad: int = 0):
        self.generator, self.frames_pad = generator, frames_pad

    def rand(self, shape: Sequence[int], frame_dims: Sequence[int]) -> torch.Tensor:
        full = list(shape)
        for d in frame_dims:
            full[d] = max(self.frames_pad, shape[d])
        r = torch.rand(full, generator=self.generator, device=self.generator.device)
        return r[tuple(slice(0, n) for n in shape)]

    def dropout(self, x: torch.Tensor, p: float, frame_dims: Sequence[int] = (1,)) -> torch.Tensor:
        if self.generator is None or p == 0.0:
            return x
        keep = self.rand(x.shape, frame_dims) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


NO_DRAWS = Draws(None)


def attention(q, k, v, heads: int, prec: Precision, draws: Draws = NO_DRAWS, p_drop: float = 0.0,
              block_bytes: int = 1 << 31) -> torch.Tensor:
    """Softmax attention over (B, T, H·D) projections, exact, one block of
    queries at a time so the (B, H, block, S) scores fit."""
    b, t, inner = q.shape
    s = k.shape[1]
    d = inner // heads
    qh = prec(q).reshape(b, t, heads, d).transpose(1, 2)
    kh = prec(k).reshape(b, s, heads, d).transpose(1, 2)
    vh = prec(v).reshape(b, s, heads, d).transpose(1, 2)
    if draws.generator is not None and p_drop > 0.0:
        block = t  # the draw is one array of the whole (B, H, T, S) probabilities
    else:
        block = max(1, min(t, block_bytes // (4 * b * heads * s)))
    outs = []
    for q0 in range(0, t, block):
        scores = qh[:, :, q0:q0 + block] @ kh.transpose(-1, -2) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        probs = draws.dropout(probs, p_drop, frame_dims=(2, 3))
        outs.append(prec(probs) @ vh)
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, inner)


def linear(x: torch.Tensor, layer: nn.Linear, prec: Precision) -> torch.Tensor:
    return F.linear(prec(x), prec(layer.weight), layer.bias)


def conv1d(x: torch.Tensor, weight, bias, prec: Precision, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """A conv over channels-last (B, T, C) → (B, T', C_out), zero-padded
    by ``padding`` frames each side: one product a tap, summed (no
    library conv algorithm, whose choice could change the rounding)."""
    b, _, c_in = x.shape
    c_out, c_group, k = weight.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding))
    t_out = (x.shape[1] - k) // stride + 1
    xg = prec(x).reshape(b, x.shape[1], groups, c_group)
    wg = prec(weight).reshape(groups, c_out // groups, c_group, k)
    y = None
    for j in range(k):
        tap = xg[:, j: j + stride * (t_out - 1) + 1: stride]
        part = torch.einsum("btgi,goi->btgo", tap, wg[..., j])
        y = part if y is None else y + part
    y = y.reshape(b, t_out, c_out)
    return y if bias is None else y + bias


# ----------------------------------------------------------------- encoder


def interpolate(x: torch.Tensor, frames: int) -> torch.Tensor:
    """Linear, align-corners resampling of (B, T, C) along T to ``frames``
    (the published ``F.interpolate(mode="linear", align_corners=True)``),
    source coordinates in float64: torch forms them in float32, which at
    thousands of frames moves each weight by up to 1e-4."""
    t = x.shape[1]
    if frames == t:
        return x
    src = np.arange(frames) * (t - 1) / max(frames - 1, 1)
    lo = np.minimum(np.floor(src).astype(np.int64), t - 2)
    w = torch.from_numpy(src - lo).float().to(x.device)[None, :, None]
    lo = torch.from_numpy(lo).to(x.device)
    return x[:, lo] * (1.0 - w) + x[:, lo + 1] * w


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, norm: bool):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=1e-5)

    def forward(self, x, prec):
        h = conv1d(x, self.conv.weight, None, prec, stride=self.stride)
        if hasattr(self, "layer_norm"):
            h = F.group_norm(h.transpose(1, 2), h.shape[-1], self.layer_norm.weight, self.layer_norm.bias,
                             self.layer_norm.eps).transpose(1, 2)
        return gelu(h)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        dims = [1] + list(cfg["conv_dim"])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, i == 0)
            for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])))


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg["conv_dim"][-1], eps=cfg["layer_norm_eps"])
        self.projection = nn.Linear(cfg["conv_dim"][-1], cfg["hidden_size"])


class _PosConv(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h, k, g = cfg["hidden_size"], cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
        self.kernel, self.groups = k, g
        self.conv = nn.Module()
        self.conv.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.conv.weight_v = nn.Parameter(torch.zeros(h, h // g, k))
        self.conv.bias = nn.Parameter(torch.zeros(h))

    def forward(self, x, prec):
        v = self.conv.weight_v
        w = self.conv.weight_g * v / v.norm(dim=(0, 1), keepdim=True)  # weight norm over dim 2
        h = conv1d(x, w, self.conv.bias, prec, padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            h = h[:, :-1]
        return gelu(h)


class _EncoderAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)
        self.v_proj, self.out_proj = nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)


class _EncoderFF(nn.Module):
    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, inner)
        self.output_dense = nn.Linear(inner, hidden)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.cfg = cfg
        self.attention = _EncoderAttention(h, cfg["num_attention_heads"])
        self.layer_norm = nn.LayerNorm(h, eps=cfg["layer_norm_eps"])
        self.feed_forward = _EncoderFF(h, cfg["intermediate_size"])
        self.final_layer_norm = nn.LayerNorm(h, eps=cfg["layer_norm_eps"])

    def forward(self, x, prec, draws):
        a, cfg = self.attention, self.cfg
        q, k, v = linear(x, a.q_proj, prec), linear(x, a.k_proj, prec), linear(x, a.v_proj, prec)
        att = linear(attention(q, k, v, a.heads, prec, draws, cfg["attention_dropout"]), a.out_proj, prec)
        x = self.layer_norm(x + draws.dropout(att, cfg["hidden_dropout"]))
        ff = gelu(linear(x, self.feed_forward.intermediate_dense, prec))
        ff = draws.dropout(ff, cfg["activation_dropout"])
        ff = linear(ff, self.feed_forward.output_dense, prec)
        return self.final_layer_norm(x + draws.dropout(ff, cfg["hidden_dropout"]))


class _Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class Wav2Vec2(nn.Module):
    """The audio encoder: waveform (B, T_a) → (B, frames, hidden)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg["hidden_size"]))
        self.encoder = _Encoder(cfg)

    def forward(self, wave: torch.Tensor, frames: int, prec: Precision, draws: Draws = NO_DRAWS,
                mask_time: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = wave[:, :, None]
        for layer in self.feature_extractor.conv_layers:
            x = layer(x, prec)
        x = interpolate(x, frames)
        fp = self.feature_projection
        h = draws.dropout(linear(fp.layer_norm(x), fp.projection, prec), cfg["feat_proj_dropout"])
        if mask_time is not None:
            h = torch.where(mask_time[:, :, None], self.masked_spec_embed, h)
        enc = self.encoder
        h = enc.layer_norm(h + enc.pos_conv_embed(h, prec))
        h = draws.dropout(h, cfg["hidden_dropout"])
        skip = [False] * len(enc.layers)
        if draws.generator is not None and cfg["layerdrop"] > 0.0:
            g = draws.generator
            skip = (torch.rand(len(enc.layers), generator=g, device=g.device) < cfg["layerdrop"]).tolist()
        for layer, skipped in zip(enc.layers, skip):
            if not skipped:
                h = layer(h, prec, draws)
        return h


# -------------------------------------------------------------------- UNet


def band(x_len: int, c_len: int, pad: int = 1):
    """SAiD's alignment band: query frame i attends to context positions
    [c_min_i, c_max_i), r = c_len / x_len, c_mid = (i + ½)·r,
    c_min = max(round(c_mid − r/2 − pad), 0), c_max = min(round(c_mid + r/2 + pad), c_len),
    rounding half to even. Returns the (x_len, W) gather index and mask."""
    r = c_len / x_len
    mid = (np.arange(x_len) + 0.5) * r
    lo = np.maximum(np.round(mid - r / 2 - pad), 0).astype(np.int64)
    hi = np.minimum(np.round(mid + r / 2 + pad), c_len).astype(np.int64)
    width = int((hi - lo).max())
    pos = lo[:, None] + np.arange(width)[None, :]
    return np.minimum(pos, c_len - 1), pos < hi[:, None]


class _CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])

    def forward(self, x, prec, draws, p_drop, context=None):
        q = linear(x, self.to_q, prec)
        if context is None:
            out = attention(q, linear(x, self.to_k, prec), linear(x, self.to_v, prec), self.heads, prec)
        else:
            k, v = linear(context, self.to_k, prec), linear(context, self.to_v, prec)
            out = banded_attention(q, k, v, self.heads, prec)
        return draws.dropout(linear(out, self.to_out[0], prec), p_drop)


def banded_attention(q, k, v, heads: int, prec: Precision) -> torch.Tensor:
    """Each query frame over its band of context positions."""
    b, t, inner = q.shape
    d = inner // heads
    idx, valid = band(t, k.shape[1])
    idx = torch.from_numpy(idx).to(q.device)
    valid = torch.from_numpy(valid).to(q.device)
    qh = prec(q).reshape(b, t, heads, d)
    kw = prec(k).reshape(b, -1, heads, d)[:, idx]  # (B, T, W, H, D)
    vw = prec(v).reshape(b, -1, heads, d)[:, idx]
    scores = torch.einsum("bthd,btwhd->bhtw", qh, kw) / math.sqrt(d)
    scores = scores.masked_fill(~valid[None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhtw,btwhd->bthd", prec(probs), vw).reshape(b, t, inner)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(dim, dim * mult * 2)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x, prec, draws, p_drop):
        h, gate = linear(x, self.net[0].proj, prec).chunk(2, dim=-1)
        return linear(draws.dropout(h * gelu(gate), p_drop), self.net[2], prec)


class _Block(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = _CrossAttention(dim, dim, heads, dim_head)
        self.ff = _GEGLU(dim)
        self.attn2 = _CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(dim), nn.LayerNorm(dim), nn.LayerNorm(dim)

    def forward(self, x, context, prec, draws, p):
        x = x + self.attn1(self.norm1(x), prec, draws, p)
        x = x + self.attn2(self.norm2(x), prec, draws, p, context)
        return x + self.ff(self.norm3(x), prec, draws, p)


def group_norm(x, norm: nn.GroupNorm, act: bool = False):
    y = F.group_norm(x.transpose(1, 2), norm.num_groups, norm.weight, norm.bias, norm.eps).transpose(1, 2)
    return silu(y) if act else y


class _SpatialTransformer(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.transformer_blocks = nn.ModuleList([_Block(ch, context_dim, heads, dim_head)])
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, context, prec, draws, p):
        h = group_norm(x, self.norm)
        for blk in self.transformer_blocks:
            h = blk(h, context, prec, draws, p)
        return x + conv1d(h, self.proj_out.weight, self.proj_out.bias, prec)


class _ResBlock(nn.Module):
    def __init__(self, c_in: int, ch: int, emb: int):
        super().__init__()
        self.in_layers = nn.ModuleList([nn.GroupNorm(32, c_in), nn.Identity(), nn.Conv1d(c_in, ch, 3, padding=1)])
        self.emb_layers = nn.ModuleList([nn.Identity(), nn.Linear(emb, ch)])
        self.out_layers = nn.ModuleList([nn.GroupNorm(32, ch), nn.Identity(), nn.Identity(),
                                         nn.Conv1d(ch, ch, 3, padding=1)])
        if c_in != ch:
            self.skip_connection = nn.Conv1d(c_in, ch, 1)

    def forward(self, x, emb, prec, draws, p):
        c = self.in_layers[2]
        h = conv1d(group_norm(x, self.in_layers[0], True), c.weight, c.bias, prec, padding=1)
        h = h + linear(silu(emb), self.emb_layers[1], prec)[:, None, :]
        h = draws.dropout(group_norm(h, self.out_layers[0], True), p)
        c = self.out_layers[3]
        h = conv1d(h, c.weight, c.bias, prec, padding=1)
        if hasattr(self, "skip_connection"):
            s = self.skip_connection
            x = conv1d(x, s.weight, s.bias, prec)
        return x + h


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cosines first (max period 10000), in float32
    as the published code forms it."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet(nn.Module):
    """in-conv → [Res, ST] → [Res, ST, Res] → 2 × [Res(skip-concat), ST] → GN·SiLU → conv."""

    def __init__(self, cfg: dict, context_dim: int):
        super().__init__()
        ch, c_io = cfg["model_channels"], cfg["in_channels"]
        heads, emb = ch // cfg["num_head_channels"], ch * 4
        dh = cfg["num_head_channels"]
        self.ch, self.p = ch, cfg["dropout"]
        self.time_embed = nn.ModuleList([nn.Linear(ch, emb), nn.Identity(), nn.Linear(emb, emb)])
        self.input_blocks = nn.ModuleList([
            nn.ModuleList([nn.Conv1d(c_io, ch, 3, padding=1)]),
            nn.ModuleList([_ResBlock(ch, ch, emb), _SpatialTransformer(ch, context_dim, heads, dh)]),
        ])
        self.middle_block = nn.ModuleList([_ResBlock(ch, ch, emb), _SpatialTransformer(ch, context_dim, heads, dh),
                                           _ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList(
            nn.ModuleList([_ResBlock(2 * ch, ch, emb), _SpatialTransformer(ch, context_dim, heads, dh)])
            for _ in range(2))
        self.out = nn.ModuleList([nn.GroupNorm(32, ch), nn.Identity(), nn.Conv1d(ch, c_io, 3, padding=1)])

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor, prec: Precision,
                draws: Draws = NO_DRAWS) -> torch.Tensor:
        """x (B, T, C), t (B,) int, context (B, T_c, E) → predicted noise (B, T, C)."""
        p = self.p
        te = timestep_embedding(t, self.ch)
        emb = linear(silu(linear(te, self.time_embed[0], prec)), self.time_embed[2], prec)
        c = self.input_blocks[0][0]
        h0 = conv1d(x, c.weight, c.bias, prec, padding=1)
        res, st = self.input_blocks[1]
        h1 = st(res(h0, emb, prec, draws, p), context, prec, draws, p)
        m0, mst, m1 = self.middle_block
        hm = m1(mst(m0(h1, emb, prec, draws, p), context, prec, draws, p), emb, prec, draws, p)
        o = torch.cat([hm, h1], dim=-1)
        res, st = self.output_blocks[0]
        o = st(res(o, emb, prec, draws, p), context, prec, draws, p)
        o = torch.cat([o, h0], dim=-1)
        res, st = self.output_blocks[1]
        o = st(res(o, emb, prec, draws, p), context, prec, draws, p)
        c = self.out[2]
        return conv1d(group_norm(o, self.out[0], True), c.weight, c.bias, prec, padding=1)


class _Denoiser(nn.Module):
    def __init__(self, unet: UNet):
        super().__init__()
        self.model = unet


class SAiD(nn.Module):
    """Parameters under the reference's names: ``audio_encoder.…``,
    ``denoiser.model.…``, ``null_cond_emb``."""

    def __init__(self, cfg: dict):
        super().__init__()
        audio, unet = cfg["audio_encoder"], cfg["unet"]
        self.audio_encoder = Wav2Vec2(audio)
        self.denoiser = _Denoiser(UNet(unet, audio["hidden_size"]))
        self.null_cond_emb = nn.Parameter(torch.zeros(1, 1, audio["output_hidden_size"]))

    @property
    def unet(self) -> UNet:
        return self.denoiser.model

    def norm_weight_names(self) -> set:
        """The scale parameters of every normalisation layer."""
        return {f"{name}.weight" for name, m in self.named_modules() if isinstance(m, (nn.GroupNorm, nn.LayerNorm))}
