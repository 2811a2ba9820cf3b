"""The port's models against the JAX package, on the CPU in float32.

Shared weights: the JAX parameters (``fast_init``'s non-degenerate rule)
go through ``said_tpu_torch.convert`` into the port, which must equal the
JAX package's own ``export_said_to_torch`` and load with ``strict=True``.
Bounds: UNet blocks and the full UNet rtol 1e-4, atol 1e-5; the encoder
the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.cli._common import fast_init
from said_tpu.core.checkpoint import export_said_to_torch
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.unet1d import BasicTransformerBlock as JBlock
from said_tpu.models.unet1d import ResBlock1D as JResBlock
from said_tpu.models.unet1d import SpatialTransformer as JST
from said_tpu.models.unet1d import build_kv_caches as j_build_kv_caches
from said_tpu.models.unet1d import time_embed_table as j_time_embed_table
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu_torch.cli._common import random_init_
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.unet1d import build_kv_caches, time_embed_table
from said_tpu_torch.models.layers import LayerNormF32
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

TOL = dict(rtol=1e-4, atol=1e-5)
# a three-layer "layer"-norm encoder (the feature extractor of wav2vec2-large's kind)
LAYER_NORM_CONFIG = dict(conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2), hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, output_hidden_size=32,
                         feat_extract_norm="layer")
THREE_LAYER = dict(conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
                   hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                   num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, output_hidden_size=32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(audio_kwargs=None):
    """(JAX model, JAX params, port model with the same weights)."""
    jm = JSAID(audio_config=JCfg(**audio_kwargs) if audio_kwargs else JCfg.tiny())
    params = jax.tree.map(np.asarray, fast_init(jm, 0))
    cfg = Wav2Vec2Config(**audio_kwargs) if audio_kwargs else Wav2Vec2Config.tiny()
    pm = SAID(audio_config=cfg).eval()
    pm.load_state_dict({k: _t(v) for k, v in said_state_dict(params).items()}, strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def test_convert_equals_export_and_loads_strict(tiny):
    _, params, pm = tiny
    got, want = said_state_dict(params), export_said_to_torch(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    sd = pm.state_dict()
    assert set(sd) == set(got)
    for k, v in got.items():
        assert np.array_equal(sd[k].numpy(), v), k


def test_full_width_names_and_shapes_match_export():
    """wav2vec2-base + the 192-wide UNet: the export's keys and shapes are
    exactly the port's state_dict (so a reference SAiD.pth loads)."""
    shapes = jax.eval_shape(
        lambda: JSAID().init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 12, 32)),
                             jnp.zeros((1,), jnp.int32), jnp.zeros((1, 12, 768)))
    )["params"]
    audio = jax.eval_shape(
        lambda: JSAID().init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3200)), 12,
                             method=JSAID.get_audio_embedding)
    )["params"]
    tree = dict(shapes, **{k: v for k, v in audio.items() if k not in shapes})
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    want = {k: v.shape for k, v in export_said_to_torch(zeros).items()}
    got = {k: tuple(v.shape) for k, v in said_state_dict(zeros).items()}
    port = {k: tuple(v.shape) for k, v in SAID().state_dict().items()}
    assert got == want == port


def test_convert_writes_the_layer_feature_norm():
    """A "layer" feature-extractor norm (wav2vec2-large's) has a LayerNorm
    on every conv layer; the JAX package's exporter skips it, the port's
    conversion writes ``conv_layers.{i}.layer_norm.{weight,bias}`` for each
    layer, equal to the JAX params, and the port's encoder of that config
    loads the result with ``strict=True``."""
    from said_tpu.models.wav2vec2 import Wav2Vec2Encoder as JEncoder
    from said_tpu_torch.convert import wav2vec2_state_dict

    cfg = JCfg(**LAYER_NORM_CONFIG)
    shapes = jax.eval_shape(lambda: JEncoder(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3200)), 12))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = wav2vec2_state_dict(params)
    for i in range(3):
        norm = params["feature_extractor"][f"conv_{i}"]["norm"]
        ln = f"audio_encoder.feature_extractor.conv_layers.{i}.layer_norm"
        assert np.array_equal(sd[f"{ln}.weight"], norm["scale"]) and np.array_equal(sd[f"{ln}.bias"], norm["bias"])
    enc = Wav2Vec2Encoder(Wav2Vec2Config(**LAYER_NORM_CONFIG, conv_bias=False))
    enc.load_state_dict({k: _t(v) for k, v in wav2vec2_state_dict(params, prefix="").items()}, strict=True)
    assert [type(layer.layer_norm) for layer in enc.feature_extractor.conv_layers] == [LayerNormF32] * 3


@pytest.mark.parametrize("lengths", [None, [6400, 4000]], ids=["plain", "lengths"])
def test_layer_feature_extractor_matches_jax(lengths):
    """The "layer" feature extractor (conv with bias → the LayerNorm router
    over channels → GELU on every layer; no fused conv) against the JAX
    ``FeatureExtractor``, f32, within 1e-5 of max |JAX|; with per-row
    lengths the pads are zero after every layer, as in the JAX package."""
    from said_tpu.models.wav2vec2 import FeatureExtractor as JFeatureExtractor
    from said_tpu.models.wav2vec2 import Wav2Vec2Encoder as JEncoder
    from said_tpu_torch.convert import wav2vec2_state_dict

    jcfg = JCfg(**LAYER_NORM_CONFIG, conv_bias=True)
    shapes = jax.eval_shape(lambda: JEncoder(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3200)), 12))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32), shapes)
    enc = Wav2Vec2Encoder(Wav2Vec2Config(**LAYER_NORM_CONFIG, conv_bias=True))
    enc.load_state_dict({k: _t(v) for k, v in wav2vec2_state_dict(params, prefix="").items()}, strict=True)
    assert not any(layer.fused for layer in enc.feature_extractor.conv_layers)
    wave = _rand((2, 6400), 11)
    j_len = None if lengths is None else jnp.asarray(lengths)
    want, want_real = JFeatureExtractor(jcfg).apply({"params": params["feature_extractor"]}, jnp.asarray(wave), j_len)
    with torch.no_grad():
        got, real = enc.feature_extractor(_t(wave), torch.float32, None if lengths is None else np.asarray(lengths))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    if lengths is not None:
        np.testing.assert_array_equal(real, np.asarray(want_real))
        assert not got[1, int(real[1]):].any()


def test_random_init_rule():
    pm = random_init_(SAID(audio_config=Wav2Vec2Config.tiny()), seed=3)
    sd = pm.state_dict()
    assert all(not v.any() for k, v in sd.items() if k.endswith("bias"))
    assert (sd["denoiser.model.out.0.weight"] == 1).all()
    assert (sd["audio_encoder.encoder.layers.0.final_layer_norm.weight"] == 1).all()
    w = sd["denoiser.model.out.2.weight"]  # zero-initialised in flax; non-degenerate here
    assert 0.015 < w.std().item() < 0.025
    pos = pm.audio_encoder.encoder.pos_conv_embed.conv
    v = pos.weight_v.double()
    eff = pos.weight_g.double() * v / torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True))
    torch.testing.assert_close(eff, v)


def test_resblock_matches_jax(tiny):
    _, params, pm = tiny
    x, emb = _rand((2, 24, 384), 0), _rand((2, 768), 1)
    p = params["denoiser"]["output_res0"]
    want = JResBlock(192).apply({"params": p}, jnp.asarray(x), jnp.asarray(emb))
    got = pm.unet.output_blocks[0][0](_t(x), _t(emb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_transformer_block_matches_jax(tiny):
    _, params, pm = tiny
    x, ctx = _rand((2, 24, 192), 2), _rand((2, 24, 32), 3)
    p = params["denoiser"]["middle_attn"]["block_0"]
    want = JBlock(6, 32).apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx))
    got = pm.unet.middle_block[1].transformer_blocks[0](_t(x), context=_t(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_spatial_transformer_matches_jax(tiny):
    _, params, pm = tiny
    x, ctx = _rand((2, 30, 192), 4), _rand((2, 17, 32), 5)
    want = JST(6, 32).apply({"params": params["denoiser"]["input_attn"]}, jnp.asarray(x), jnp.asarray(ctx))
    got = pm.unet.input_blocks[1][1](_t(x), _t(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_unet_forward_matches_jax(tiny):
    jm, params, pm = tiny
    x, ctx, t = _rand((2, 24, 32), 6), _rand((2, 24, 32), 7), np.array([999, 17])
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = pm(_t(x), _t(t), _t(ctx))
    assert np.asarray(want).std() > 1e-3
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_unet_cfg_fold_matches_jax(tiny):
    """Sampling fast path: K/V caches, timestep table and the CFG
    shared-prefix fold, against the JAX fast path and the unfolded port."""
    jm, params, pm = tiny
    x, ctx = _rand((1, 24, 32), 8), _rand((2, 24, 32), 9)  # [uncond, cond]
    ts = np.arange(1000)
    j_kv = j_build_kv_caches(params["denoiser"], jnp.asarray(ctx), 24, num_heads=6, dtype=jnp.float32)
    j_table = j_time_embed_table(params["denoiser"], ts, 192)
    kv, table = build_kv_caches(pm.unet, _t(ctx), 24), time_embed_table(pm.unet, ts)
    np.testing.assert_allclose(table.numpy(), np.asarray(j_table), **TOL)
    for name, blocks in j_kv.items():
        for (jk, jv, jvalid), (k, v, valid) in zip(blocks, kv[name]):
            np.testing.assert_allclose(k.detach().numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), **TOL)
            np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    t = 421
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), None,
                    kv_caches=j_kv, emb=j_table[t], cfg_fold=True)
    got = pm.unet(_t(x), kv_caches=kv, emb=table[t], cfg_fold=True).detach().numpy()
    assert got.shape == (2, 24, 32)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    unfolded = pm.unet(_t(np.concatenate([x, x])), torch.tensor(t), _t(ctx)).detach().numpy()
    np.testing.assert_allclose(got, unfolded, **TOL)


@pytest.mark.parametrize("audio_kwargs", [None, THREE_LAYER], ids=["tiny", "three_layer"])
def test_encoder_matches_jax(audio_kwargs):
    jm, params, pm = _pair(audio_kwargs)
    fused = [layer.fused for layer in pm.audio_encoder.feature_extractor.conv_layers]
    assert fused == [False] + [True] * (len(fused) - 1)  # k∈{2,3} stride-2 layers take the kernel path
    wave = _rand((1, 6400), 10)
    want = jm.apply({"params": params}, jnp.asarray(wave), 24, method=JSAID.get_audio_embedding)
    got = pm.get_audio_embedding(_t(wave), 24).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# --------------------------------------------------------------- bfloat16


def _rel_max(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def tiny_bf16(tiny):
    """The tiny port model with bfloat16 compute on the same weights."""
    _, _, pm = tiny
    pb = SAID(audio_config=Wav2Vec2Config.tiny(), dtype=torch.bfloat16).eval()
    pb.load_state_dict(pm.state_dict(), strict=True)
    return pm, pb


def test_dense_caches_its_cast_weight(tiny_bf16):
    """Where no gradient is recorded (sampling runs under no_grad) the cast
    weight is cached until the parameter changes; where one is, it is
    derived anew with autograd, so the gradient reaches the parameter."""
    _, pb = tiny_bf16
    dense = pb.unet.middle_block[1].transformer_blocks[0].attn1.to_q
    with torch.no_grad():
        w = dense.weight_as(torch.bfloat16)
        assert w.dtype == torch.bfloat16 and dense.weight_as(torch.bfloat16) is w
        assert dense.weight_as(torch.float32) is dense.weight
        dense.weight.mul_(1.0)  # an in-place update invalidates the cache
        assert dense.weight_as(torch.bfloat16) is not w
    tracked = dense.weight_as(torch.bfloat16)
    assert tracked.grad_fn is not None
    tracked.float().sum().backward()
    assert dense.weight.grad is not None and (dense.weight.grad == 1).all()
    dense.weight.grad = None


def test_positional_conv_bf16_tracks_f32(tiny_bf16):
    """The grouped positional conv in bfloat16 mode (bf16 operands, f32
    accumulation) within 1e-2 of float32, relative to max |f32|."""
    pm, pb = tiny_bf16
    x = _t(_rand((1, 40, 32), 12, 0.1))
    want = pm.audio_encoder.encoder.pos_conv_embed(x)
    got = pb.audio_encoder.encoder.pos_conv_embed(x.bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel_max(got, want) <= 1e-2


@pytest.mark.parametrize("t", [999, 20])
def test_bf16_encoder_and_denoiser_track_f32(tiny_bf16, t):
    """bfloat16 compute on the same weights and inputs: the audio embedding
    within 2e-2 and one CFG-folded denoiser call within 3e-2 of float32,
    relative to max |f32| (bf16 keeps 8 bits: ~4e-3 per rounding)."""
    pm, pb = tiny_bf16
    wave = _t(_rand((1, 6400), 13))
    x = _t(_rand((1, 24, 32), 14))
    out = {}
    with torch.no_grad():
        for m in (pm, pb):
            emb = m.get_audio_embedding(wave, 24)
            ctx = torch.cat([m.null_embedding(1, 24), emb])
            kv, table = build_kv_caches(m.unet, ctx, 24), time_embed_table(m.unet, np.arange(1000))
            out[m.dtype] = (emb, m.unet(x, kv_caches=kv, emb=table[t], cfg_fold=True))
    (emb32, eps32), (emb16, eps16) = out[torch.float32], out[torch.bfloat16]
    assert emb16.dtype == torch.bfloat16 and eps16.dtype == torch.float32
    assert eps32.std().item() > 1e-3
    assert _rel_max(emb16, emb32) <= 2e-2
    assert _rel_max(eps16, eps32) <= 3e-2
