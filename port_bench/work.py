"""The work a request must do, counted from shapes,
and the card's published peaks: the yardstick of ``step_mfu.*`` and
``attn_roofline.serve``.

Operations count 2 a multiply-add of every product (linear layers,
convolutions, attention's QKᵀ and PV); normalisations, activations and
other elementwise work are left out, so a share of the peak is a lower
bound of what the card did. Counts follow the configuration's widths:

- the encoder at a clip's frame count F (its features are interpolated
  to F before the transformer), its conv stack at the clip's samples;
- serving: the encoder, the K/V projections of the context for the four
  cross-attentions (both CFG halves: 2·F rows), the timestep MLP over
  all training timesteps, and a step of the UNet at batch 2, but for the
  work before the first cross-attention, which the CFG pair shares and
  the step runs once (batch 1).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), 700 W: tensor-core
# peaks and HBM3 bandwidth. float32 is held against TF32's peak, the
# fastest rate at which the card multiplies f32 operands, so no f32 path
# can read above 100%.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
PEAKS_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet (SXM5): BF16 989 TFLOP/s, TF32 495 TFLOP/s, HBM3 3.35 TB/s"

# frames past which the program routes self-attention to its flash kernel
FLASH_MIN_FRAMES = 2049
BYTES = {"bfloat16": 2, "float32": 4}


def _conv_frames(samples: int, kernels, strides) -> List[int]:
    out, t = [], samples
    for k, s in zip(kernels, strides):
        t = (t - k) // s + 1
        out.append(t)
    return out


def encoder_flops(cfg: dict, samples: int, frames: int, batch: int = 1) -> float:
    a = cfg["audio_encoder"]
    dims = [1] + list(a["conv_dim"])
    flops = 0.0
    for i, t in enumerate(_conv_frames(samples, a["conv_kernel"], a["conv_stride"])):
        flops += 2.0 * t * dims[i] * dims[i + 1] * a["conv_kernel"][i]
    h, inner = a["hidden_size"], a["intermediate_size"]
    flops += 2.0 * frames * dims[-1] * h  # feature projection
    k = a["num_conv_pos_embeddings"]  # SAME-padded; an even kernel computes one frame more, then drops it
    flops += 2.0 * (frames + 1 - k % 2) * h * (h // a["num_conv_pos_embedding_groups"]) * k
    per_layer = 4 * 2.0 * frames * h * h + 4.0 * frames * frames * h + 2 * 2.0 * frames * h * inner
    return batch * (flops + a["num_hidden_layers"] * per_layer)


def _unet_dims(cfg: dict) -> Tuple[int, int, int, int]:
    u = cfg["unet"]
    return u["model_channels"], u["in_channels"], cfg["audio_encoder"]["hidden_size"], 3


def unet_flops(cfg: dict, frames: int, batch: int, shared_batch: int, training: bool) -> float:
    """One UNet forward at ``batch`` rows of ``frames``; the in-conv, the
    first ResBlock and the first transformer's self-attention run at
    ``shared_batch`` rows. ``training``: the forward runs the timestep MLP
    and the cross-attentions project the context; serving reads both
    from tables and K/V caches made in prepare."""
    ch, c_io, ctx, band = _unet_dims(cfg)
    t, emb = frames, 4 * ch

    def res(c_in, b):
        f = 2.0 * t * c_in * ch * 3 + 2.0 * emb * ch + 2.0 * t * ch * ch * 3
        return b * (f + (2.0 * t * c_in * ch if c_in != ch else 0.0))

    def self_attn(b):
        return b * (4 * 2.0 * t * ch * ch + 4.0 * t * t * ch)

    def rest_of_st(b):  # after the self-attention
        f = 2 * 2.0 * t * ch * ch + 4.0 * t * band * ch  # to_q, to_out, banded scores and PV
        f += (2 * 2.0 * t * ctx * ch) if training else 0.0
        f += 2.0 * t * ch * 8 * ch + 2.0 * t * 4 * ch * ch  # GEGLU
        return b * (f + 2.0 * t * ch * ch)  # proj_out

    flops = shared_batch * 2.0 * t * c_io * ch * 3 + res(ch, shared_batch) + self_attn(shared_batch)
    flops += rest_of_st(batch)
    flops += res(ch, batch) + self_attn(batch) + rest_of_st(batch) + res(ch, batch)
    flops += 2 * (res(2 * ch, batch) + self_attn(batch) + rest_of_st(batch))
    flops += batch * 2.0 * t * ch * c_io * 3
    if training:
        flops += batch * (2.0 * ch * emb + 2.0 * emb * emb)
    return flops


def request_flops(cfg: dict, samples: int, frames: int, steps: int) -> float:
    """A guided request: prepare (encoder, K/V caches, timestep table) and
    ``steps`` denoise steps."""
    ch, _, ctx, _ = _unet_dims(cfg)
    prepare = encoder_flops(cfg, samples, frames)
    prepare += 4 * 2 * 2.0 * (2 * frames) * ctx * ch  # to_k, to_v of both halves, four transformers
    prepare += cfg["diffusion_steps"] * (2.0 * ch * 4 * ch + 2.0 * (4 * ch) ** 2)
    return prepare + steps * unet_flops(cfg, frames, 2, 1, training=False)


def self_attention_calls(cfg: dict, frames: int, steps: int) -> List[Tuple[int, int, int, int]]:
    """(batch, frames, heads, head dim) of every self-attention call of a
    guided request: the encoder's layers once, then a step's four
    transformers (the first at batch 1, before the CFG pair splits)."""
    a, u = cfg["audio_encoder"], cfg["unet"]
    enc = (1, frames, a["num_attention_heads"], a["hidden_size"] // a["num_attention_heads"])
    heads = u["model_channels"] // u["num_head_channels"]
    first = (1, frames, heads, u["num_head_channels"])
    rest = (2, frames, heads, u["num_head_channels"])
    return [enc] * a["num_hidden_layers"] + steps * ([first] + [rest] * 3)


def attention_bound_s(calls, dtype: str) -> float:
    """The least time the card could take for ``calls`` of self-attention:
    each call the larger of its operations (4·B·H·T²·D) over the peak and
    its bytes (Q, K, V read once, O written once) over the bandwidth."""
    total = 0.0
    for b, t, h, d in calls:
        ops = 4.0 * b * h * t * t * d
        nbytes = 4.0 * b * t * h * d * BYTES[dtype]
        total += max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)
    return total


def flash_calls(cfg: dict, requests: List[Dict]) -> list:
    """The self-attention calls of ``requests`` long enough for the flash
    kernel."""
    calls = []
    for r in requests:
        calls += [c for c in self_attention_calls(cfg, r["frames"], r["steps"]) if c[1] >= FLASH_MIN_FRAMES]
    return calls
