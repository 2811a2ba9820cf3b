"""The slice end to end: ``SAIDPipeline.inference`` of both packages.

The tiny encoder and the 192-wide UNet share weights (``fast_init`` →
``said_tpu_torch.convert``); a 0.4-s clip (24 frames), 10 DDIM or
DPM-Solver++(2M) steps, CFG 2.0, on the CPU in float32. The long-clip
path is driven at this size by lowering the port's ``DENSE_MAX`` to 0, so
the plain flash version serves every self-attention, against the JAX
pipeline built with ``self_attn_impl="flash"`` under
``SAID_FLASH_INTERPRET=1``, which runs K1 (``_flash_tpu_packed``) in
interpret mode in the UNet and the encoder. torch and JAX draw different numbers
from one seed, so the port is handed the JAX pipeline's own draws,
rebuilt with ``jax.random`` from the same splits: the latents
(``said.py:624``), the per-step eta noise (``sampler.py:105,166``) and
the editing noise (``sampler.py:95,100``).

Bound: coefficient MAE ≤ 1e-5 and max ≤ 1e-4. (With random weights the
chain amplifies float differences with the step count — a 1e-6 latent
perturbation reaches ~1.7e-3 after 100 JAX steps — so the slice is held
at 10 steps.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.cli._common import fast_init
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.said import SAIDPipeline as JPipeline
from said_tpu.models.said import process_audio as j_process_audio
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID, SAIDPipeline, process_audio
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.ops import attention

SEED, STEPS, FRAMES, C = 7, 10, 24, 32


@pytest.fixture(scope="module")
def pipelines():
    jm = JSAID(audio_config=JCfg.tiny())
    params = jax.tree.map(np.asarray, fast_init(jm, 0))
    pm = SAID(audio_config=Wav2Vec2Config.tiny()).eval()
    pm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in said_state_dict(params).items()})
    rng = np.random.default_rng(0)
    t = np.arange(6400) / 16000
    wave = np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.1 * rng.standard_normal(6400)
    raw = wave.astype(np.float32)
    wave = process_audio(raw)
    np.testing.assert_array_equal(wave, j_process_audio(raw))
    return JPipeline(jm, params), SAIDPipeline(pm), wave, params


def _jax_draws(k):
    """The JAX pipeline's draws for rng=PRNGKey(SEED): latents, editing
    noise, and the eta noise of each of the k used steps."""
    rng, lat_rng = jax.random.split(jax.random.PRNGKey(SEED))
    rng, init_rng = jax.random.split(rng)
    shape = (1, FRAMES, C)
    latents = jax.random.normal(lat_rng, shape, jnp.float32)
    edit_noise = jax.random.normal(init_rng, shape, jnp.float32)
    eta_noise = jnp.stack([jax.random.normal(r, shape, jnp.float32) for r in jax.random.split(rng, k)])
    return np.asarray(latents), np.asarray(edit_noise), np.asarray(eta_noise)


def _assert_slice_close(got, want):
    diff = np.abs(got - want)
    assert got.shape == want.shape
    assert diff.mean() <= 1e-5 and diff.max() <= 1e-4, (diff.mean(), diff.max())


def test_denoiser_output_is_not_trivial(pipelines):
    _, tp, wave, _ = pipelines
    kv, table = tp.prepare(torch.from_numpy(wave), FRAMES, True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, FRAMES, C)).astype(np.float32))
    with torch.no_grad():
        eps = tp.model.unet(x, kv_caches=kv, emb=table[500], cfg_fold=True)
    assert eps.shape == (2, FRAMES, C) and eps.std().item() > 1e-3


def test_pipeline_eta0_matches_jax(pipelines):
    jp, tp, wave, _ = pipelines
    latents, _, _ = _jax_draws(STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, save_intermediate=True)
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw)
    got = tp.inference(wave, latents=latents, **kw)
    _assert_slice_close(got.result, want.result)
    assert got.intermediates.shape == (STEPS, 1, FRAMES, C)
    np.testing.assert_allclose(got.intermediates, want.intermediates, atol=1e-4, rtol=0)
    assert 0.0 <= got.result.min() and got.result.max() <= 1.0 and got.result.std() > 1e-3


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_pipeline_eta_noise_matches_jax(pipelines, rescale):
    jp, tp, wave, _ = pipelines
    latents, _, eta_noise = _jax_draws(STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, guidance_rescale=rescale, eta=0.5)
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw).result
    got = tp.inference(wave, latents=latents, eta_noise=eta_noise, **kw).result
    _assert_slice_close(got, want)


def test_pipeline_masked_editing_matches_jax(pipelines):
    jp, tp, wave, _ = pipelines
    rng = np.random.default_rng(2)
    init = rng.uniform(0.0, 1.0, (1, FRAMES, C)).astype(np.float32)
    mask = np.zeros((1, FRAMES, C), np.float32)
    mask[:, : FRAMES // 2] = 1.0
    used = int(STEPS * 0.7)
    _, edit_noise, _ = _jax_draws(used)
    kw = dict(init_samples=init, mask=mask, num_inference_steps=STEPS, strength=0.7, guidance_scale=2.0)
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw).result
    got = tp.inference(wave, edit_noise=edit_noise, **kw).result
    _assert_slice_close(got, want)
    # the masked region lands on the init at the final step
    np.testing.assert_allclose(got[:, : FRAMES // 2], init[:, : FRAMES // 2], atol=1e-5)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp_2m"])
def test_pipeline_flash_path_matches_jax(pipelines, solver, monkeypatch):
    _, tp, wave, params = pipelines
    latents, _, _ = _jax_draws(STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, solver=solver)
    monkeypatch.setenv("SAID_FLASH_INTERPRET", "1")
    jp = JPipeline(JSAID(audio_config=JCfg.tiny(), self_attn_impl="flash"), params)
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw).result

    calls = []
    plain = attention.flash_attention_plain

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(attention, "DENSE_MAX", 0)
    monkeypatch.setattr(attention, "flash_attention_plain", counted)
    got = tp.inference(wave, latents=latents, **kw).result
    _assert_slice_close(got, want)
    # 4 UNet self-attentions per step, one per encoder layer
    assert len(calls) == 4 * STEPS + tp.model.audio_config.num_hidden_layers


def test_pipeline_dpmpp_matches_jax(pipelines):
    jp, tp, wave, _ = pipelines
    latents, _, _ = _jax_draws(STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=2.0, solver="dpmpp_2m", save_intermediate=True)
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw)
    got = tp.inference(wave, latents=latents, **kw)
    _assert_slice_close(got.result, want.result)
    np.testing.assert_allclose(got.intermediates, want.intermediates, atol=1e-4, rtol=0)
    assert got.result.std() > 1e-3


def test_pipeline_dpmpp_masked_editing_matches_jax(pipelines):
    jp, tp, wave, _ = pipelines
    rng = np.random.default_rng(3)
    init = rng.uniform(0.0, 1.0, (1, FRAMES, C)).astype(np.float32)
    mask = np.zeros((1, FRAMES, C), np.float32)
    mask[:, FRAMES // 2:] = 1.0
    used = int(STEPS * 0.7)
    _, edit_noise, _ = _jax_draws(used)
    kw = dict(init_samples=init, mask=mask, num_inference_steps=STEPS, strength=0.7, guidance_scale=2.0,
              solver="dpmpp_2m")
    want = jp.inference(wave, rng=jax.random.PRNGKey(SEED), denoise_chunk=0, **kw).result
    got = tp.inference(wave, edit_noise=edit_noise, **kw).result
    _assert_slice_close(got, want)
    np.testing.assert_allclose(got[:, FRAMES // 2:], init[:, FRAMES // 2:], atol=1e-5)
