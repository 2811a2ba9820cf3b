"""Streaming long-clip serving in the port (``SAIDPipeline.inference_streaming``)
against the JAX package's, on the CPU.

The JAX package draws one key a window, which the port cannot reproduce,
so the two are held apart in two ways:

- bookkeeping: both run with ``inference`` replaced by one deterministic
  stand-in (a function of the wave slice, which keeps the pinned rows of
  an init, as the editing path does); the wave slices, inits and masks
  every window receives and the stitched output must be identical;
- numerics, in the port alone: with injected per-window noise, each window
  equals the port's own ``inference`` on the same inputs, and every seam is
  bit-exact (the JAX package's seam contract, tests/test_streaming.py).
"""

import types

import numpy as np
import pytest
import torch

from said_tpu.models.said import SAIDPipeline as JSAIDPipeline
from said_tpu_torch.cli._common import random_init_
from said_tpu_torch.models.said import (
    SAID,
    SAIDInferenceOutput,
    SAIDPipeline,
    process_audio,
    streaming_starts,
)
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

FPS, SR, C = 60, 16000, 32
# tests/test_streaming.py's small pipeline
SMALL = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3), conv_bias=False, hidden_size=24,
             num_hidden_layers=2, num_attention_heads=2, intermediate_size=48, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, output_hidden_size=24)


def _wave(frames, seed=0, batch=1):
    n = int(round(frames * SR / FPS))
    return process_audio(np.random.default_rng(seed).standard_normal((batch, n)).astype(np.float32))


def _recording_pipeline(calls):
    """A stand-in for either package's pipeline: ``inference`` maps the
    wave slice to coefficients deterministically, keeps an init's pinned
    rows, and records what it was given."""
    def inference(wave, init_samples=None, mask=None, **kwargs):
        wave = np.array(wave)
        b, n = wave.shape
        frames = int(n / SR * FPS)
        res = 0.5 + 0.5 * np.tanh(3.0 * wave[:, : frames * C].reshape(b, frames, C))
        if init_samples is not None:
            res = np.where(mask > 0, init_samples, res)
        calls.append((wave, None if init_samples is None else np.array(init_samples),
                      None if mask is None else np.array(mask)))
        return SAIDInferenceOutput(result=res.astype(np.float32))

    return types.SimpleNamespace(model=types.SimpleNamespace(in_channels=C), sampling_rate=SR, inference=inference)


@pytest.mark.parametrize("total,window,overlap,batch", [
    (24, 24, 6, 1),  # fits one window: delegation
    (40, 24, 6, 1),  # the last window moved back: starts 0, 16
    (42, 24, 9, 2),  # a batch of 2
    (96, 24, 6, 1),  # 5 windows, 4 seams
    (21600, 3600, 360, 1),  # the 6-min request: 7 windows
], ids=["delegation", "final_window_realigned", "batch_2", "five_windows", "six_minutes"])
def test_window_bookkeeping_matches_jax(total, window, overlap, batch):
    wave = _wave(total, seed=total, batch=batch)
    got_calls, want_calls = [], []
    kw = dict(window_frames=window, overlap_frames=overlap, num_inference_steps=3, guidance_scale=2.0)
    got = SAIDPipeline.inference_streaming(_recording_pipeline(got_calls), wave, **kw).result
    want = JSAIDPipeline.inference_streaming(_recording_pipeline(want_calls), wave, **kw).result
    assert len(got_calls) == len(want_calls) == len(streaming_starts(total, window, overlap))
    for g, w in zip(got_calls, want_calls):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (batch, total, C)


def test_streaming_starts():
    assert streaming_starts(21600, 3600, 360) == [0, 3240, 6480, 9720, 12960, 16200, 18000]
    assert streaming_starts(1200, 600, 120) == [0, 480, 600]
    assert streaming_starts(40, 24, 6) == [0, 16]
    assert streaming_starts(24, 24, 6) == [0]


@pytest.mark.parametrize("window,overlap,match", [(20, 6, "multiple of 3"), (24, 24, "overlap_frames"),
                                                  (24, 0, "overlap_frames")])
def test_validation_matches_jax(window, overlap, match):
    wave = _wave(30)
    for cls in (SAIDPipeline, JSAIDPipeline):
        with pytest.raises(ValueError, match=match):
            cls.inference_streaming(_recording_pipeline([]), wave, window_frames=window, overlap_frames=overlap)


# ------------------------------------------------------------ numerics


@pytest.fixture(scope="module")
def small_pipeline():
    return SAIDPipeline(random_init_(SAID(audio_config=Wav2Vec2Config(**SMALL)), seed=0).eval())


def _window_noise(starts, window, steps, batch, seed, eta):
    rng = np.random.default_rng(seed)
    noise = []
    for k in range(len(starts)):
        arrays = {"latents" if k == 0 else "edit_noise": rng.standard_normal((batch, window, C)).astype(np.float32)}
        if eta > 0:
            arrays["eta_noise"] = rng.standard_normal((steps, batch, window, C)).astype(np.float32)
        noise.append(arrays)
    return noise


@pytest.mark.parametrize("solver,eta", [("ddim", 0.0), ("ddim", 0.5), ("dpmpp_2m", 0.0)])
def test_windows_equal_their_own_inference_and_seams_are_exact(small_pipeline, solver, eta):
    """96 frames in 24-frame windows, overlap 6 (5 windows): each window of
    the streaming run equals ``inference`` called by hand on its wave slice,
    init, mask and injected noise; each later window's raw result equals
    its init on the pinned rows bit for bit; the stitched clip is finite
    and in [0, 1]; a second run is identical (nothing drawn)."""
    total, w, o, steps = 96, 24, 6, 4
    wave = _wave(total, seed=9)
    starts = streaming_starts(total, w, o)
    noise = _window_noise(starts, w, steps, 1, seed=3, eta=eta)
    kw = dict(num_inference_steps=steps, guidance_scale=2.0, eta=eta, solver=solver)
    calls = []
    inference = small_pipeline.inference

    def spy(wave_k, **kwargs):
        res = inference(wave_k, **kwargs)
        calls.append((wave_k, kwargs, res.result))
        return res

    small_pipeline.inference = spy
    try:
        out = small_pipeline.inference_streaming(wave, window_frames=w, overlap_frames=o, window_noise=noise,
                                                 **kw).result
    finally:
        del small_pipeline.inference
    assert out.shape == (1, total, C) and np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    assert len(calls) == len(starts) == 5
    covered = 0
    for k, (start, (wave_k, kwargs, res)) in enumerate(zip(starts, calls)):
        again = small_pipeline.inference(wave_k, **kwargs).result
        np.testing.assert_array_equal(again, res)
        kept = covered - start if k else 0
        if k:
            init = kwargs["init_samples"]
            np.testing.assert_array_equal(res[:, :kept], init[:, :kept])  # the seam
            assert kept >= o and (kwargs["mask"][:, :kept] == 1).all() and not kwargs["mask"][:, kept:].any()
        np.testing.assert_array_equal(out[:, covered : start + w], res[:, kept:])
        covered = start + w
    again = small_pipeline.inference_streaming(wave, window_frames=w, overlap_frames=o, window_noise=noise, **kw)
    np.testing.assert_array_equal(again.result, out)


def test_short_clip_delegates_to_inference(small_pipeline):
    wave = _wave(24, seed=5)
    lat = np.random.default_rng(5).standard_normal((1, 24, C)).astype(np.float32)
    kw = dict(num_inference_steps=4, guidance_scale=2.0)
    got = small_pipeline.inference_streaming(wave, window_frames=24, overlap_frames=6,
                                             window_noise=[{"latents": lat}], **kw).result
    np.testing.assert_array_equal(got, small_pipeline.inference(wave, latents=lat, **kw).result)


def test_window_noise_must_cover_every_window(small_pipeline):
    with pytest.raises(ValueError, match="window_noise holds 1 windows, the clip has 2"):
        small_pipeline.inference_streaming(_wave(40), window_frames=24, overlap_frames=6, window_noise=[{}])


def test_generator_draws_reproducibly(small_pipeline):
    """Without injected noise every window draws from the one generator:
    the same seed gives the same clip, another seed another."""
    wave = _wave(40, seed=2)
    kw = dict(window_frames=24, overlap_frames=6, num_inference_steps=3, guidance_scale=2.0)
    a, b, c = (small_pipeline.inference_streaming(wave, generator=torch.Generator().manual_seed(s), **kw).result
               for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
