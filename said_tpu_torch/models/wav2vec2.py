"""Wav2Vec2 audio encoder in PyTorch, channels-last, deterministic path.

Port of ``said_tpu.models.wav2vec2`` (the architecture of
``facebook/wav2vec2-base-960h``): a 7-layer strided conv feature
extractor, align-corners interpolation of the features to the
blendshape frame count (the reference's one modification), the feature
projection, a weight-normed grouped positional conv and post-norm
transformer layers. Module and parameter names are the HF torch names
(``feature_extractor.conv_layers.0.conv.weight``,
``encoder.layers.0.attention.q_proj.weight``, …).

Kernels on this path: the per-channel GroupNorm of ``conv_0``, every
LayerNorm, and the stride-2 conv+GELU of the norm-free k∈{2,3} layers
(``conv_1`` … ``conv_6`` in wav2vec2-base). Not ported yet: spec-augment
(``compute_time_mask_indices``, training only), layerdrop and dropout,
length-bucketed mode, and the "layer" feature-extractor norm.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from said_tpu_torch.models.layers import Dense, Derived, GroupNorm32, LayerNormF32
from said_tpu_torch.ops.attention import self_attention
from said_tpu_torch.ops.conv import strided_conv_gelu
from said_tpu_torch.ops.resample import linear_interp_time


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (defaults = wav2vec2-base)."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    output_hidden_size: int = 768

    @classmethod
    def tiny(cls) -> "Wav2Vec2Config":
        """The JAX package's tiny test encoder (``Wav2Vec2Config.tiny``)."""
        return cls(
            conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
            hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, output_hidden_size=32,
        )


class _ConvLayer(nn.Module):
    """One feature-extractor conv layer: conv (+ per-channel GroupNorm) + GELU.

    Norm-free stride-2 layers with k ∈ {2, 3} and no bias take the fused
    stride-2 conv+GELU kernel; the others (``conv_0``: k=10, s=5, then the
    GroupNorm kernel) are one plain GEMM over the unfolded input.
    """

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int,
                 bias: bool, group_norm: bool, eps: float):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.fused = stride == 2 and kernel in (2, 3) and not bias and not group_norm
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride=stride, bias=bias)
        self.layer_norm = GroupNorm32(out_dim, num_groups=out_dim, eps=eps) if group_norm else None
        # fused kernel: (C_out, C_in, K) -> (K, C_in, C_out); GEMM: (C_out, C_in·K)
        self._w = Derived(
            (lambda w: w.permute(2, 1, 0)) if self.fused else (lambda w: w.reshape(w.shape[0], -1))
        )
        self._b = Derived()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.fused:
            return strided_conv_gelu(x, self._w(self.conv.weight, dt))
        # (B, T, C_in) -> (B, T', C_in, K) -> (B, T', C_in·K), the torch weight's order
        cols = x.unfold(1, self.kernel, self.stride).reshape(x.shape[0], -1, x.shape[2] * self.kernel)
        bias = None if self.conv.bias is None else self._b(self.conv.bias, dt)
        h = F.linear(cols, self._w(self.conv.weight, dt), bias)
        if self.layer_norm is not None:
            h = self.layer_norm(h)
        return F.gelu(h)


class FeatureExtractor(nn.Module):
    """Strided conv stack: raw waveform (B, T_a) → features (B, T', 512)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        if config.feat_extract_norm != "group":
            raise NotImplementedError("only the 'group' feature-extractor norm is ported")
        dims = (1,) + tuple(config.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, config.conv_bias, i == 0, config.layer_norm_eps)
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride))
        )

    def forward(self, input_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = input_values[:, :, None].to(dtype)
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNormF32(config.conv_dim[-1], config.layer_norm_eps)
        self.projection = Dense(config.conv_dim[-1], config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (SAME padding, trailing frame
    dropped for even k) + GELU. Holds the reference's weight-norm pair
    (``weight_g`` (1, 1, k), ``weight_v``) and computes the effective
    weight ``g · v / ‖v‖`` (norm over dims 0, 1, in float64) per call —
    the encoder runs once per clip."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        h, k, g = config.hidden_size, config.num_conv_pos_embeddings, config.num_conv_pos_embedding_groups
        self.kernel, self.groups = k, g
        conv = nn.Module()
        conv.weight_g = nn.Parameter(torch.ones(1, 1, k))
        conv.weight_v = nn.Parameter(torch.zeros(h, h // g, k))
        conv.bias = nn.Parameter(torch.zeros(h))
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # In bfloat16 mode the operands are rounded to bf16 and the conv
        # accumulates in f32, like every product of the port. (torch's CPU
        # bf16 grouped conv1d returns wrong values: a relative error above
        # 1 against f32 in torch 2.13.)
        dt = x.dtype
        v = self.conv.weight_v.double()
        norm = torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True))
        w = (self.conv.weight_g.double() * (v / norm)).to(dt).float()
        h = F.conv1d(x.transpose(1, 2).float(), w, self.conv.bias.float(),
                     padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            h = h[:, :, :-1]
        return F.gelu(h.transpose(1, 2)).to(dt).contiguous()


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(hidden, hidden)
        self.k_proj = Dense(hidden, hidden)
        self.v_proj = Dense(hidden, hidden)
        self.out_proj = Dense(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = Dense(hidden, intermediate)
        self.output_dense = Dense(intermediate, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (wav2vec2-base style)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        h = config.hidden_size
        self.attention = Attention(h, config.num_attention_heads)
        self.layer_norm = LayerNormF32(h, config.layer_norm_eps)
        self.feed_forward = FeedForward(h, config.intermediate_size)
        self.final_layer_norm = LayerNormF32(h, config.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = LayerNormF32(config.hidden_size, config.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_hidden_layers))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        for layer in self.layers:
            h = layer(h)
        return h


class Wav2Vec2Encoder(nn.Module):
    """Full audio conditioner: waveform (B, T_a) → (B, num_frames, hidden).

    ``num_frames`` is the blendshape window size; ``None`` keeps the
    native ~50 Hz feature rate. ``dtype`` is the compute dtype.
    """

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.feature_extractor = FeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        # spec-augment's learned mask vector: held for state_dict parity,
        # used only in training
        self.masked_spec_embed = nn.Parameter(torch.zeros(config.hidden_size))
        self.encoder = Encoder(config)

    def extract_features(self, input_values: torch.Tensor, num_frames=None) -> torch.Tensor:
        """Conv stack + align-corners interpolation to ``num_frames``."""
        feats = self.feature_extractor(input_values, self.dtype)
        return feats if num_frames is None else linear_interp_time(feats, num_frames)

    def forward(self, input_values: torch.Tensor, num_frames=None) -> torch.Tensor:
        feats = self.extract_features(input_values, num_frames)
        return self.encoder(self.feature_projection(feats))
