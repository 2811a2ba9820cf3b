"""Real-weights acceptance of the port, wherever the released assets exist
(each test skips here, where they do not ship; nothing is downloaded).

    SAID_WEIGHTS_PATH   the released SAiD.pth
    SAID_TEST_WAV       optional 16 kHz mono WAV; a synthetic clip otherwise
    ACCEPTANCE_STEPS    DDIM steps of the end-to-end check (default 1000)
    WAV2VEC2_DIR        a local snapshot of facebook/wav2vec2-base-960h
                        (model.safetensors or pytorch_model.bin)

1. ``SAiD.pth`` through the port's ``load_said_weights`` (``strict=True``:
   every tensor of the released file has its place in the port, and the
   other way round) and through the JAX package's ``convert_said``; the
   same wave and injected latents through both pipelines on the CPU:
   coefficient MAE < 1e-3, the north star of
   ``tests/test_acceptance_real_weights.py``.
2. The snapshot through the port's loader (``load_audio_encoder_snapshot``)
   and the JAX package's ``convert_wav2vec2``: the encoder's last hidden
   state within 2e-4 abs and 1e-3 rel.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.cli._common import build_said_model as jax_build_said_model
from said_tpu.models.said import SAIDPipeline as JaxPipeline
from said_tpu.models.said import process_audio
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JaxWav2Vec2Config
from said_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxWav2Vec2Encoder
from said_tpu.utils.torch_import import convert_said, convert_wav2vec2, load_state_dict
from said_tpu_torch.cli._common import build_said_model, load_audio_encoder_snapshot, load_said_weights
from said_tpu_torch.models.said import SAIDPipeline
from said_tpu_torch.utils.hf_snapshot import load_snapshot, snapshot_file


def _said_weights():
    path = os.environ.get("SAID_WEIGHTS_PATH", "")
    if not (path and os.path.isfile(path)):
        pytest.skip("SAID_WEIGHTS_PATH not set / file missing (the released SAiD.pth does not ship here)")
    return path


def _wav2vec2_dir():
    path = os.environ.get("WAV2VEC2_DIR", "")
    if not (path and os.path.isdir(path) and snapshot_file(path) is not None):
        pytest.skip("WAV2VEC2_DIR not set / no HF snapshot of wav2vec2-base-960h")
    return path


def _load_wave():
    path = os.environ.get("SAID_TEST_WAV", "")
    if path and os.path.isfile(path):
        from said_tpu_torch.utils.audio import load_audio

        return load_audio(path, 16000)[None].astype(np.float32)
    return np.random.default_rng(0).standard_normal((1, 16000 * 2)).astype(np.float32)


def test_said_pth_port_against_the_jax_package():
    path = _said_weights()
    wave = process_audio(_load_wave())
    window = int(wave.shape[1] / 16000 * 60)
    latents = np.random.default_rng(2).standard_normal((1, window, 32)).astype(np.float32)
    steps = int(os.environ.get("ACCEPTANCE_STEPS", "1000"))

    model = load_said_weights(build_said_model(dtype="float32"), path)
    got = SAIDPipeline(model.eval()).inference(wave, num_inference_steps=steps, guidance_scale=2.0,
                                               latents=latents).result
    want = JaxPipeline(jax_build_said_model(dtype="float32", attn_impl="auto"),
                       convert_said(load_state_dict(path))).inference(
        waveform_processed=wave, num_inference_steps=steps, guidance_scale=2.0, latents=latents).result
    assert got.shape == want.shape == (1, window, 32)
    mae = float(np.abs(np.asarray(got) - np.asarray(want)).mean())
    assert mae < 1e-3, f"port against the JAX package: coefficient MAE {mae} >= 1e-3"


def test_wav2vec2_snapshot_port_against_the_jax_package():
    directory = _wav2vec2_dir()
    model = build_said_model(dtype="float32")
    load_audio_encoder_snapshot(model, directory)
    sd = {k: v.numpy() for k, v in load_snapshot(directory).items()}
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    params = convert_wav2vec2(sd, prefix=prefix)

    wave = process_audio(np.random.default_rng(0).standard_normal((1, 16000)).astype(np.float32))
    with torch.no_grad():
        got = model.audio_encoder.eval()(torch.from_numpy(wave), None).numpy()
    want = np.asarray(JaxWav2Vec2Encoder(JaxWav2Vec2Config()).apply({"params": params}, jnp.asarray(wave), None))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
