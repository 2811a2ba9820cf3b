"""JAX parameter tree → this package's ``state_dict`` (numpy only).

Mirrors ``said_tpu.core.checkpoint.export_said_to_torch`` (:192), which
this package cannot import (that module imports jax). The port's module
names are the reference's torch names, so the result — like a reference
``SAiD.pth`` — loads into ``said_tpu_torch.models.said.SAID`` with
``strict=True``:

    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})

One difference: a "layer" feature-extractor norm (every conv layer's
``norm``) is written as ``conv_layers.{i}.layer_norm``, which the JAX
exporter leaves out.

Layouts: flax Dense ``kernel`` (in, out) → ``weight`` (out, in); flax
Conv ``kernel`` (k, in, out) → ``weight`` (out, in, k); norm ``scale`` →
``weight``. The positional conv is written as its weight-norm pair
(g = per-position norm over dims 0, 1; v = the weight).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

StateDict = Dict[str, np.ndarray]


def _dense(p: Mapping, name: str, out: StateDict) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(p: Mapping, name: str, out: StateDict) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _norm(p: Mapping, name: str, out: StateDict) -> None:
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def unet1d_state_dict(params: Mapping, prefix: str = "denoiser.model.") -> StateDict:
    """JAX ``UNet1DConditionModel`` params → torch names under ``prefix``."""
    out: StateDict = {}

    def res(fl, tp):
        _norm(fl["in_norm"], f"{tp}.in_layers.0", out)
        _conv(fl["in_conv"], f"{tp}.in_layers.2", out)
        _dense(fl["emb_proj"], f"{tp}.emb_layers.1", out)
        _norm(fl["out_norm"], f"{tp}.out_layers.0", out)
        _conv(fl["out_conv"], f"{tp}.out_layers.3", out)
        if "skip" in fl:
            _conv(fl["skip"], f"{tp}.skip_connection", out)

    def st(fl, tp):
        _norm(fl["norm"], f"{tp}.norm", out)
        _conv(fl["proj_out"], f"{tp}.proj_out", out)
        d = 0
        while f"block_{d}" in fl:
            b = fl[f"block_{d}"]
            bp = f"{tp}.transformer_blocks.{d}"
            for attn in ("attn1", "attn2"):
                for proj in ("to_q", "to_k", "to_v"):
                    _dense(b[attn][proj], f"{bp}.{attn}.{proj}", out)
                _dense(b[attn]["to_out"], f"{bp}.{attn}.to_out.0", out)
            for n in ("norm1", "norm2", "norm3"):
                _norm(b[n], f"{bp}.{n}", out)
            _dense(b["ff"]["proj"], f"{bp}.ff.net.0.proj", out)
            _dense(b["ff"]["out"], f"{bp}.ff.net.2", out)
            d += 1

    p = prefix.rstrip(".")
    _dense(params["time_embed_0"], f"{p}.time_embed.0", out)
    _dense(params["time_embed_2"], f"{p}.time_embed.2", out)
    _conv(params["input_conv"], f"{p}.input_blocks.0.0", out)
    res(params["input_res"], f"{p}.input_blocks.1.0")
    st(params["input_attn"], f"{p}.input_blocks.1.1")
    res(params["middle_res1"], f"{p}.middle_block.0")
    st(params["middle_attn"], f"{p}.middle_block.1")
    res(params["middle_res2"], f"{p}.middle_block.2")
    res(params["output_res0"], f"{p}.output_blocks.0.0")
    st(params["output_attn0"], f"{p}.output_blocks.0.1")
    res(params["output_res1"], f"{p}.output_blocks.1.0")
    st(params["output_attn1"], f"{p}.output_blocks.1.1")
    _norm(params["out_norm"], f"{p}.out.0", out)
    _conv(params["out_conv"], f"{p}.out.2", out)
    return out


def wav2vec2_state_dict(params: Mapping, prefix: str = "audio_encoder.") -> StateDict:
    """JAX ``Wav2Vec2Encoder`` params → HF torch names under ``prefix``."""
    out: StateDict = {}
    p = prefix
    fe = params["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        layer = fe[f"conv_{i}"]
        _conv(layer["conv"], f"{p}feature_extractor.conv_layers.{i}.conv", out)
        ln = f"{p}feature_extractor.conv_layers.{i}.layer_norm"
        if "norm_scale" in layer:  # "group" norm (conv_0 of wav2vec2-base)
            out[f"{ln}.weight"] = np.asarray(layer["norm_scale"])
            out[f"{ln}.bias"] = np.asarray(layer["norm_bias"])
        elif "norm" in layer:  # "layer" norm: every conv layer has one
            _norm(layer["norm"], ln, out)
        i += 1

    _norm(params["fp_layer_norm"], f"{p}feature_projection.layer_norm", out)
    _dense(params["fp_projection"], f"{p}feature_projection.projection", out)
    if "masked_spec_embed" in params:
        out[f"{p}masked_spec_embed"] = np.asarray(params["masked_spec_embed"])

    w = np.asarray(params["pos_conv"]["conv"]["kernel"]).transpose(2, 1, 0)
    g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)).astype(w.dtype)
    out[f"{p}encoder.pos_conv_embed.conv.weight_g"] = g
    out[f"{p}encoder.pos_conv_embed.conv.weight_v"] = w
    out[f"{p}encoder.pos_conv_embed.conv.bias"] = np.asarray(params["pos_conv"]["conv"]["bias"])
    _norm(params["encoder_layer_norm"], f"{p}encoder.layer_norm", out)

    li = 0
    while f"layer_{li}" in params:
        lp = params[f"layer_{li}"]
        tp = f"{p}encoder.layers.{li}"
        for ours, theirs in (
            ("q_proj", "attention.q_proj"), ("k_proj", "attention.k_proj"),
            ("v_proj", "attention.v_proj"), ("out_proj", "attention.out_proj"),
            ("ff_inter", "feed_forward.intermediate_dense"),
            ("ff_out", "feed_forward.output_dense"),
        ):
            _dense(lp[ours], f"{tp}.{theirs}", out)
        _norm(lp["layer_norm"], f"{tp}.layer_norm", out)
        _norm(lp["final_layer_norm"], f"{tp}.final_layer_norm", out)
        li += 1
    return out


def said_state_dict(params: Mapping) -> StateDict:
    """Full JAX ``SAID`` params → the port's (and the reference's) state_dict."""
    out = unet1d_state_dict(params["denoiser"])
    out.update(wav2vec2_state_dict(params["audio_encoder"]))
    out["null_cond_emb"] = np.asarray(params["null_cond_emb"])
    if "audio_proj_layer" in params:
        _dense(params["audio_proj_layer"], "audio_proj_layer", out)
    return out
