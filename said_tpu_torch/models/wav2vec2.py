"""Wav2Vec2 audio encoder in PyTorch, channels-last, deterministic path.

Port of ``said_tpu.models.wav2vec2`` (the architecture of
``facebook/wav2vec2-base-960h``): a 7-layer strided conv feature
extractor, align-corners interpolation of the features to the
blendshape frame count (the reference's one modification), the feature
projection, a weight-normed grouped positional conv and post-norm
transformer layers. Module and parameter names are the HF torch names
(``feature_extractor.conv_layers.0.conv.weight``,
``encoder.layers.0.attention.q_proj.weight``, …).

Kernels on this path: the per-channel GroupNorm of ``conv_0`` (masked
in length-bucketed mode), every LayerNorm, and the stride-2 conv+GELU of
the norm-free k∈{2,3} layers (``conv_1`` … ``conv_6`` in
wav2vec2-base). Length-bucketed mode (``input_length`` /
``num_frames_real``) carries each conv layer's real length, zeroes pads
after every layer, resamples with the dynamic interpolation and masks
padded keys in every attention, so the real frames equal an unpadded
run.

Train mode (a ``torch.Generator`` passed as ``generator``; the SAiD
trainer runs the frozen encoder so, as the reference leaves the HF module
in train mode): feature-projection, hidden, activation and
attention-probability dropout and layerdrop at the config's rates, drawn
from that generator; attention is then always the dense form (the
probabilities are dropped out). Spec-augment: ``mask_time_indices``
(``compute_time_mask_indices``, host-side numpy) replaces masked frames
by the learned ``masked_spec_embed``. The "layer" feature-extractor norm
(``feat_extract_norm="layer"``) runs the conv with its bias, the
LayerNorm kernel router over the channels and GELU on every conv layer.

Sequence-parallel serving (``seq_group``, a ``parallel.mesh.AxisGroup``):
the conv stack and the interpolation run unsharded on every rank, then
the features are cut to this rank's frames; the positional conv takes a
halo of k/2 frames before and (k−1)/2 after from the neighbouring ranks
(so the even k's dropped trailing frame is dropped once, at the clip's
end), attention gathers K and V (``flash_attention_flat_sp``), and the
row-wise LayerNorms and projections run on the local frames. Serving only:
under sequence-parallel training the frozen encoder runs whole on every
rank (``SAID.get_audio_embedding``).

Tensor parallelism (``parallel.tensor.shard_model_``): each layer's
attention holds its rank's heads and its feed-forward a block of the
intermediate units; their inputs pass ``parallel.tensor.enter`` and their
output projections sum over the model axis. Train-mode dropout of the
attention probabilities is drawn for every head and sliced to the rank's,
the activation dropout for every unit and sliced to the rank's columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from said_tpu_torch.models.layers import Dense, Derived, Frames, GroupNorm32, LayerNormF32, dropout
from said_tpu_torch.ops.attention import dense_attention, flash_attention_flat_sp, self_attention
from said_tpu_torch.ops.conv import strided_conv_gelu
from said_tpu_torch.ops.resample import linear_interp_time, linear_interp_time_dynamic
from said_tpu_torch.parallel.mesh import unsliced
from said_tpu_torch.parallel.seq import halo, shard_frames, sharded
from said_tpu_torch.parallel.tensor import block_draws, enter


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
    # train-mode stochasticity (HF wav2vec2-base values)
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    layerdrop: float = 0.1

    def feature_extract_output_length(self, input_length):
        """Output frame count of the conv stack for a waveform length (an
        int or an integer numpy array)."""
        length = input_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length

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
    """One feature-extractor conv layer: conv (+ a norm) + GELU.

    ``norm`` is None (or False), "group" (per-channel GroupNorm over time: ``conv_0``
    of the "group" config) or "layer" (LayerNorm over the channels: every
    layer of the "layer" config), both stored as ``layer_norm`` (the HF
    name). Norm-free stride-2 layers with k ∈ {2, 3} and no bias take the
    fused stride-2 conv+GELU kernel; the others (``conv_0``: k=10, s=5;
    every "layer" layer, as in the JAX package, which runs those convs
    outside Pallas) are one plain GEMM over the unfolded input, then the
    norm's kernel.
    """

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int,
                 bias: bool, norm: Optional[str], eps: float):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.fused = stride == 2 and kernel in (2, 3) and not bias and not norm
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride=stride, bias=bias)
        self.layer_norm = None
        if norm == "group":
            self.layer_norm = GroupNorm32(out_dim, num_groups=out_dim, eps=eps)
        elif norm == "layer":
            self.layer_norm = LayerNormF32(out_dim, eps)
        # fused kernel: (C_out, C_in, K) -> (C_out, K, C_in), read as the
        # packed (K, C_in, C_out) kernel (ops.conv.pack_weight); GEMM: (C_out, C_in·K)
        self._w = Derived(
            (lambda w: w.permute(0, 2, 1)) if self.fused else (lambda w: w.reshape(w.shape[0], -1))
        )
        self._b = Derived()

    def forward(self, x: torch.Tensor, frames: Optional[Frames] = None) -> torch.Tensor:
        dt = x.dtype
        if self.fused:
            h = strided_conv_gelu(x, self._w(self.conv.weight, dt).permute(1, 2, 0))
        else:
            # (B, T, C_in) -> (B, T', C_in, K) -> (B, T', C_in·K), the torch weight's order
            cols = x.unfold(1, self.kernel, self.stride).reshape(x.shape[0], -1, x.shape[2] * self.kernel)
            bias = None if self.conv.bias is None else self._b(self.conv.bias, dt)
            h = F.linear(cols, self._w(self.conv.weight, dt), bias)
            if isinstance(self.layer_norm, GroupNorm32):
                h = self.layer_norm(h, None if frames is None else frames.lengths)
            elif self.layer_norm is not None:  # per frame: pads need no mask
                h = self.layer_norm(h)
            h = F.gelu(h)
        # pads stay exactly zero, so the next VALID conv's real outputs
        # read only real samples
        return h if frames is None else frames.zero(h)


class FeatureExtractor(nn.Module):
    """Strided conv stack: raw waveform (B, T_a) → features (B, T', 512)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        if config.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"unknown feat_extract_norm: {config.feat_extract_norm!r}")
        dims = (1,) + tuple(config.conv_dim)

        def norm(i):
            if config.feat_extract_norm == "layer":
                return "layer"
            return "group" if i == 0 else None

        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, config.conv_bias, norm(i), config.layer_norm_eps)
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride))
        )

    def forward(self, input_values: torch.Tensor, dtype: torch.dtype, input_length=None):
        """Returns the features and, when ``input_length`` (real sample
        count: an int or (B,) numpy lengths) is given, their real length."""
        x = input_values[:, :, None].to(dtype)
        real = None if input_length is None else np.asarray(input_length, np.int64)
        for layer in self.conv_layers:
            frames = None
            if real is not None:
                real = (real - layer.kernel) // layer.stride + 1
                t_out = (x.shape[1] - layer.kernel) // layer.stride + 1
                frames = Frames(real, x.shape[0], t_out, x.device, dtype)
            x = layer(x, frames)
        return x, real


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

    def forward(self, x: torch.Tensor, seq_group=None) -> torch.Tensor:
        # In bfloat16 mode the operands are rounded to bf16 and the conv
        # accumulates in f32, like every product of the port. (torch's CPU
        # bf16 grouped conv1d returns wrong values: a relative error above
        # 1 against f32 in torch 2.13.)
        dt = x.dtype
        v = self.conv.weight_v.double()
        norm = torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True))
        w = (self.conv.weight_g.double() * (v / norm)).to(dt).float()
        if sharded(seq_group):
            # output t reads inputs t − k/2 … t + (k−1)/2: VALID over the halo
            # gives this rank's frames exactly
            xh = halo(x, self.kernel // 2, (self.kernel - 1) // 2, seq_group)
            h = F.conv1d(xh.transpose(1, 2).float(), w, self.conv.bias.float(), groups=self.groups)
        else:
            h = F.conv1d(x.transpose(1, 2).float(), w, self.conv.bias.float(),
                         padding=self.kernel // 2, groups=self.groups)
            if self.kernel % 2 == 0:
                h = h[:, :, :-1]
        return F.gelu(h.transpose(1, 2)).to(dt).contiguous()


class Attention(nn.Module):
    model_group = None  # ``heads`` are this rank's where set (parallel.tensor)

    def __init__(self, hidden: int, heads: int, attention_dropout: float = 0.0):
        super().__init__()
        self.heads, self.attention_dropout = heads, attention_dropout
        self.q_proj = Dense(hidden, hidden)
        self.k_proj = Dense(hidden, hidden)
        self.v_proj = Dense(hidden, hidden)
        self.out_proj = Dense(hidden, hidden)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        x = enter(x, self.model_group)
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if sharded(seq_group):
            out = flash_attention_flat_sp(q, k, v, self.heads, seq_group, lengths)
        elif generator is None:
            out = self_attention(q, k, v, self.heads, lengths)
        else:  # train mode: dense at any length, its probabilities dropped out
            heads = block_draws(generator, 1, self.heads, self.model_group)
            out = dense_attention(q, k, v, self.heads, lengths,
                                  probs=lambda p: dropout(p, self.attention_dropout, heads))
        return self.out_proj(out)


class FeedForward(nn.Module):
    model_group = None  # the dense layers hold this rank's block where set (parallel.tensor)

    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = Dense(hidden, intermediate)
        self.output_dense = Dense(intermediate, hidden)

    def forward(self, x: torch.Tensor, activation_dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(self.intermediate_dense(enter(x, self.model_group)))
        h = dropout(h, activation_dropout, block_draws(generator, 2, h.shape[-1], self.model_group))
        return self.output_dense(h)


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (wav2vec2-base style)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.attention = Attention(h, config.num_attention_heads, config.attention_dropout)
        self.layer_norm = LayerNormF32(h, config.layer_norm_eps)
        self.feed_forward = FeedForward(h, config.intermediate_size)
        self.final_layer_norm = LayerNormF32(h, config.layer_norm_eps)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        p = self.config.hidden_dropout
        x = self.layer_norm(x + dropout(self.attention(x, lengths, generator, seq_group), p, generator))
        ff = self.feed_forward(x, self.config.activation_dropout, generator)
        return self.final_layer_norm(x + dropout(ff, p, generator))


class Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = LayerNormF32(config.hidden_size, config.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_hidden_layers))

    def forward(self, h: torch.Tensor, frames: Optional[Frames] = None,
                generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        if frames is not None:
            # the SAME-padded positional conv must see the zero boundary an
            # unpadded run would
            h = frames.zero(h)
        h = self.layer_norm(h + self.pos_conv_embed(h, seq_group))
        h = dropout(h, self.config.hidden_dropout, generator)
        skip = [False] * len(self.layers)
        if generator is not None and self.config.layerdrop > 0.0:
            # layerdrop: HF skips a whole layer with this probability in
            # train mode (one draw a layer, read on the host at once)
            base = unsliced(generator)  # one draw a layer, the same on every rank
            draws = torch.rand(len(self.layers), generator=base, device=base.device)
            skip = (draws < self.config.layerdrop).tolist()
        for layer, skipped in zip(self.layers, skip):
            if not skipped:
                h = layer(h, None if frames is None else frames.lengths, generator, seq_group)
        return h


class Wav2Vec2Encoder(nn.Module):
    """Full audio conditioner: waveform (B, T_a) → (B, num_frames, hidden).

    ``num_frames`` is the blendshape window size; ``None`` keeps the
    native ~50 Hz feature rate. ``dtype`` is the compute dtype.

    Length-bucketed mode: ``input_length`` (real samples) and
    ``num_frames_real`` (real frames), ints or (B,) numpy lengths within
    the padded buffers; the first ``num_frames_real`` output frames of a
    row equal its unpadded run.
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

    def extract_features(self, input_values: torch.Tensor, num_frames=None, input_length=None,
                         num_frames_real=None):
        """Conv stack + align-corners interpolation to ``num_frames`` →
        (features, their real frame count or None)."""
        feats, feat_len = self.feature_extractor(input_values, self.dtype, input_length)
        if num_frames is not None:
            if input_length is None:
                feats = linear_interp_time(feats, num_frames)
            else:
                feats = linear_interp_time_dynamic(feats, num_frames, feat_len, num_frames_real)
                feat_len = num_frames_real
        return feats, feat_len

    def encode_features(self, feats: torch.Tensor, real_frames=None, mask_time_indices=None,
                        generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        """Feature projection + transformer encoder; ``real_frames`` (an int
        or (B,) numpy lengths) in bucketed mode; ``mask_time_indices``
        (B, T) bool (spec-augment) replaces masked frames by
        ``masked_spec_embed``; ``generator`` runs train mode; ``seq_group``:
        ``feats`` are this rank's frames of a clip sharded over it, and so
        is the result (serving only)."""
        if sharded(seq_group) and (real_frames is not None or mask_time_indices is not None or generator is not None):
            raise ValueError("the frame-sharded encoder is serving-only: no lengths, spec-augment or train mode")
        h = dropout(self.feature_projection(feats), self.config.feat_proj_dropout, generator)
        if mask_time_indices is not None:
            m = torch.as_tensor(mask_time_indices, device=h.device)[:, :, None]
            h = torch.where(m, self.masked_spec_embed.to(h.dtype), h)
        frames = None if real_frames is None else Frames(real_frames, h.shape[0], h.shape[1], h.device, h.dtype)
        return self.encoder(h, frames, generator, seq_group)

    def forward(self, input_values: torch.Tensor, num_frames=None, input_length=None,
                num_frames_real=None, mask_time_indices=None,
                generator: Optional[torch.Generator] = None, seq_group=None) -> torch.Tensor:
        """``seq_group``: the conv stack and the interpolation run unsharded,
        then the encoder on this rank's frames (the result's frames too)."""
        feats, real = self.extract_features(input_values, num_frames, input_length, num_frames_real)
        feats = shard_frames(feats, seq_group)
        return self.encode_features(feats, real, mask_time_indices, generator, seq_group)


def compute_time_mask_indices(
    shape: Tuple[int, int],
    mask_prob: float = 0.05,
    mask_length: int = 10,
    rng: Optional[np.random.Generator] = None,
    min_masks: int = 2,
    input_lengths: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side spec-augment time-mask sampler (HF's
    ``_compute_mask_indices``), the JAX package's
    ``compute_time_mask_indices`` (said_tpu/models/wav2vec2.py:497) draw
    for draw, so the same ``np.random.Generator`` gives the same mask:
    one epsilon draw per call for probabilistic rounding, per-row span
    counts from ``input_lengths``, the two clamps (spans·length ≤ T;
    spans ≤ input_length − mask_length + 1), and dummy-index padding of
    short rows. Returns a (B, T) bool array; True marks masked steps."""
    b, t = shape
    rng = rng or np.random.default_rng()
    mask = np.zeros((b, t), dtype=bool)
    if mask_length >= t:
        # HF raises for mask_length > T; training windows are >= 120 frames
        return mask
    if input_lengths is None:
        input_lengths = [t] * b

    epsilon = rng.random()

    def num_spans(input_length: int) -> int:
        n = int(mask_prob * input_length / mask_length + epsilon)
        n = max(n, min_masks)
        if n * mask_length > t:
            n = t // mask_length
        if input_length - (mask_length - 1) < n:
            n = max(input_length - (mask_length - 1), 0)
        return n

    max_spans = num_spans(t)
    if max_spans == 0:
        return mask

    for i, input_length in enumerate(input_lengths):
        n = num_spans(int(input_length))
        starts = rng.choice(int(input_length) - (mask_length - 1), size=n, replace=False)
        # a row shorter than one span pads with T - 1 (a padding frame), as HF
        dummy = t - 1 if len(starts) == 0 else starts[0]
        starts = np.concatenate([starts, np.full(max_spans - n, dummy, dtype=np.int64)])
        for s in starts:
            mask[i, s : min(s + mask_length, t)] = True
    return mask
