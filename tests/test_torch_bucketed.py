"""Length-bucketed and mixed-length batches: the port against the JAX
package, and bucketed against exact inside the port, on the CPU in float32.

Shared weights as in ``test_torch_pipeline.py`` (tiny encoder, the
192-wide UNet, ``fast_init`` → ``said_tpu_torch.convert``). Bounds:
encoder and UNet rtol 1e-4 / atol 1e-5 on the real frames (padded frames
hold garbage in both packages); the pipeline coefficient MAE ≤ 1e-5 and
max ≤ 1e-4 on the real frames at 5 DDIM steps with injected latents; the
port's bucketed run against its exact-shape run atol 5e-5 / rtol 1e-3,
the JAX package's own bound (``tests/test_bucketed.py``). The flash path
runs at this size by lowering the port's ``DENSE_MAX`` to 0, against the
JAX pipeline with ``self_attn_impl="flash"`` under
``SAID_FLASH_INTERPRET=1`` (K1 with lengths, in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.cli._common import fast_init
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.said import SAIDPipeline as JPipeline
from said_tpu.models.unet1d import build_kv_caches as j_build_kv_caches
from said_tpu.models.unet1d import time_embed_table as j_time_embed_table
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID, SAIDPipeline, process_audio
from said_tpu_torch.models.unet1d import build_kv_caches, time_embed_table
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.ops import attention

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS, C, BUCKET = 5, 32, 32
# 0.4 s and 0.25 s: 24 and 15 frames, both in the 32-frame bucket
SAMPLES = (6400, 4000)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    jm = JSAID(audio_config=JCfg.tiny())
    params = jax.tree.map(np.asarray, fast_init(jm, 0))
    pm = SAID(audio_config=Wav2Vec2Config.tiny()).eval()
    pm.load_state_dict({k: _t(v) for k, v in said_state_dict(params).items()}, strict=True)
    return jm, params, pm


def _waves(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for n in SAMPLES:
        t = np.arange(n) / 16000
        w = np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.1 * rng.standard_normal(n)
        rows.append(process_audio(w.astype(np.float32))[0])
    return rows


def _frames(n):
    return int(n / 16000 * 60)


# ----------------------------------------------------------------- models


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_encoder_bucketed_matches_jax(pair, per_row):
    jm, params, pm = pair
    wave = np.zeros((2, 8000), np.float32)
    wave[:, :6400] = _rand((2, 6400), 1)
    if per_row:
        wave[1, 4000:] = 0.0
        lens, frames = np.array(SAMPLES), np.array([_frames(n) for n in SAMPLES])
    else:
        lens, frames = 6400, 24
    want = jm.apply({"params": params}, jnp.asarray(wave), 32, method=JSAID.get_audio_embedding,
                    input_length=jnp.asarray(lens), num_frames_real=jnp.asarray(frames))
    got = pm.get_audio_embedding(_t(wave), 32, lens, frames).detach().numpy()
    for i, n in enumerate(np.broadcast_to(frames, (2,))):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], **TOL)
    # each row's real frames equal its unpadded run
    exact = pm.get_audio_embedding(_t(wave[1:, : lens if not per_row else lens[1]]),
                                   int(np.broadcast_to(frames, (2,))[1])).detach().numpy()
    n = int(np.broadcast_to(frames, (2,))[1])
    np.testing.assert_allclose(got[1, :n], exact[0], atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("seq_len_real", [30, [30, 41]], ids=["scalar", "per_row"])
def test_unet_bucketed_matches_jax(pair, seq_len_real):
    jm, params, pm = pair
    x, ctx, t = _rand((2, 48, C), 2), _rand((2, 48, 32), 3), np.array([999, 17])
    slr = np.asarray(seq_len_real)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                    seq_len_real=jnp.asarray(slr))
    got = pm(_t(x), _t(t), _t(ctx), seq_len_real=slr if slr.ndim else int(slr)).detach().numpy()
    assert np.asarray(want).std() > 1e-3
    for i, n in enumerate(np.broadcast_to(slr, (2,))):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], **TOL)


@pytest.mark.parametrize("seq_len_real", [30, [30, 41]], ids=["scalar", "per_row"])
def test_unet_bucketed_fast_path_matches_jax(pair, seq_len_real):
    """K/V caches with the dynamic band (per-row gathers for (B,)
    lengths), the fold for one length, the unfolded batch for per-row."""
    jm, params, pm = pair
    slr = np.asarray(seq_len_real)
    per_row = slr.ndim == 1
    ctx = _rand((4 if per_row else 2, 48, 32), 4)  # [uncond, cond]
    x = _rand((4 if per_row else 1, 48, C), 5)
    cfg_slr = np.concatenate([slr, slr]) if per_row else int(slr)
    j_kv = j_build_kv_caches(params["denoiser"], jnp.asarray(ctx), 48, num_heads=6, dtype=jnp.float32,
                             seq_len_real=jnp.asarray(cfg_slr))
    kv = build_kv_caches(pm.unet, _t(ctx), 48, seq_len_real=cfg_slr)
    for name, blocks in j_kv.items():
        for (jk, jv, jvalid), (k, v, valid) in zip(blocks, kv[name]):
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
            np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    ts = np.arange(1000)
    j_table, table = j_time_embed_table(params["denoiser"], ts, 192), time_embed_table(pm.unet, ts)
    tt = 421
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tt), None, kv_caches=j_kv,
                    emb=j_table[tt], seq_len_real=jnp.asarray(cfg_slr), cfg_fold=not per_row)
    with torch.no_grad():
        got = pm.unet(_t(x), kv_caches=kv, emb=table[tt], cfg_fold=not per_row,
                      seq_len_real=_t(cfg_slr).int() if per_row else cfg_slr).numpy()
    rows = 4 if per_row else 2
    assert got.shape == (rows, 48, C)
    for i, n in enumerate(np.broadcast_to(cfg_slr, (rows,))):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], **TOL)


def test_cfg_fold_refuses_per_row_lengths(pair):
    _, _, pm = pair
    kv = build_kv_caches(pm.unet, _t(_rand((2, 16, 32), 6)), 16)
    with pytest.raises(ValueError, match="per-row"):
        pm.unet(_t(_rand((1, 16, C), 7)), kv_caches=kv, emb=torch.zeros(768), cfg_fold=True,
                seq_len_real=np.array([10]))


# --------------------------------------------------------------- pipeline


def _assert_slice_close(got, want):
    diff = np.abs(got - want)
    assert got.shape == want.shape
    assert diff.mean() <= 1e-5 and diff.max() <= 1e-4, (diff.mean(), diff.max())


def _mixed_batch(waves):
    batch = np.zeros((2, max(SAMPLES)), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    return batch


@pytest.fixture(scope="module")
def pipelines(pair):
    jm, params, pm = pair
    return JPipeline(jm, params), SAIDPipeline(pm), params


def test_pipeline_bucketed_matches_jax(pipelines):
    jp, tp, _ = pipelines
    wave = _waves()[0][None]
    latents = _rand((1, 24, C), 8)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, latents=latents, length_bucket=BUCKET)
    want = jp.inference(wave, rng=jax.random.PRNGKey(0), denoise_chunk=0, **kw).result
    got = tp.inference(wave, **kw).result
    assert got.shape == (1, BUCKET, C)
    _assert_slice_close(got[:, :24], want[:, :24])
    assert got[:, :24].std() > 1e-3


@pytest.mark.parametrize("solver", ["ddim", "dpmpp_2m"])
def test_pipeline_mixed_lengths_match_jax(pipelines, solver):
    jp, tp, _ = pipelines
    batch = _mixed_batch(_waves())
    latents = _rand((2, 24, C), 9)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, latents=latents, length_bucket=BUCKET,
              waveform_lengths=np.array(SAMPLES), solver=solver)
    want = jp.inference(batch, rng=jax.random.PRNGKey(0), denoise_chunk=0, **kw).result
    got = tp.inference(batch, **kw).result
    for i, n in enumerate(SAMPLES):
        _assert_slice_close(got[i, : _frames(n)], want[i, : _frames(n)])


def test_pipeline_flash_path_with_lengths_matches_jax(pipelines, monkeypatch):
    """Mixed lengths on the flash path: every self-attention of the UNet
    and the encoder takes (B,) lengths."""
    _, tp, params = pipelines
    batch = _mixed_batch(_waves())
    latents = _rand((2, 24, C), 10)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, latents=latents, length_bucket=BUCKET,
              waveform_lengths=np.array(SAMPLES))
    monkeypatch.setenv("SAID_FLASH_INTERPRET", "1")
    jp = JPipeline(JSAID(audio_config=JCfg.tiny(), self_attn_impl="flash"), params)
    want = jp.inference(batch, rng=jax.random.PRNGKey(0), denoise_chunk=0, **kw).result

    calls = []
    plain = attention.flash_attention_plain

    def counted(q, k, v, h, lengths=None):
        calls.append(None if lengths is None else lengths.tolist())
        return plain(q, k, v, h, lengths)

    monkeypatch.setattr(attention, "DENSE_MAX", 0)
    monkeypatch.setattr(attention, "flash_attention_plain", counted)
    got = tp.inference(batch, **kw).result
    for i, n in enumerate(SAMPLES):
        _assert_slice_close(got[i, : _frames(n)], want[i, : _frames(n)])
    frames = [_frames(n) for n in SAMPLES]
    # encoder layers once at (B,), then 4 UNet self-attentions a step at the
    # unfolded CFG batch (2B)
    assert calls == [frames] * tp.model.audio_config.num_hidden_layers + [frames * 2] * (4 * STEPS)


def test_bucketed_matches_exact_in_the_port(pipelines):
    """One length padded to the bucket, and each row of a mixed batch,
    against the port's own exact-shape run."""
    _, tp, _ = pipelines
    waves = _waves(1)
    latents = [_rand((1, _frames(n), C), 11 + i) for i, n in enumerate(SAMPLES)]
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0)
    exact = [tp.inference(w[None], latents=lat, **kw).result[0] for w, lat in zip(waves, latents)]
    single = tp.inference(waves[1][None], latents=latents[1], length_bucket=BUCKET, **kw).result[0]
    np.testing.assert_allclose(single[: _frames(SAMPLES[1])], exact[1], atol=5e-5, rtol=1e-3)
    lat_batch = np.zeros((2, 24, C), np.float32)
    for i, lat in enumerate(latents):
        lat_batch[i, : lat.shape[1]] = lat[0]
    mixed = tp.inference(_mixed_batch(waves), latents=lat_batch, length_bucket=BUCKET,
                         waveform_lengths=np.array(SAMPLES), **kw).result
    for i, n in enumerate(SAMPLES):
        np.testing.assert_allclose(mixed[i, : _frames(n)], exact[i], atol=5e-5, rtol=1e-3)


def test_waveform_lengths_need_a_bucket(pipelines):
    _, tp, _ = pipelines
    with pytest.raises(ValueError, match="length_bucket"):
        tp.inference(_mixed_batch(_waves()), num_inference_steps=2, waveform_lengths=np.array(SAMPLES))
    with pytest.raises(ValueError, match="real frame"):
        tp.inference(_mixed_batch(_waves()), num_inference_steps=2, length_bucket=BUCKET,
                     waveform_lengths=np.array([6400, 100]))
