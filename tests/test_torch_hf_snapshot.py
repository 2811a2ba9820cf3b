"""``--init_weights`` / ``--weights_path`` from an HF wav2vec2 snapshot
directory, on the CPU: the port's safetensors reader against the
``safetensors`` package, and the audio embedding after
``load_said_weights`` against the JAX package's ``load_said_params`` on a
tiny config (within 1e-5 of max), from ``model.safetensors`` and from
``pytorch_model.bin``, with and without the ``wav2vec2.`` prefix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from said_tpu.cli import _common as jcommon
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu_torch.cli import train
from said_tpu_torch.cli._common import load_said_weights
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.utils.hf_snapshot import read_safetensors


def hf_state_dict(prefix, seed=0):
    """An HF-named audio encoder of the tiny config with random weights,
    and the HF model's extras."""
    rng = np.random.default_rng(seed)
    enc = SAID(audio_config=Wav2Vec2Config.tiny()).audio_encoder.state_dict()
    sd = {prefix + k: torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32))
          for k, v in enc.items()}
    sd["lm_head.weight"] = torch.zeros(5, 32)
    sd["lm_head.bias"] = torch.zeros(5)
    return sd


@pytest.mark.parametrize("fmt,prefix", [("safetensors", "wav2vec2."), ("bin", "wav2vec2."), ("safetensors", "")],
                         ids=["safetensors", "bin", "safetensors_no_prefix"])
def test_snapshot_embedding_matches_the_jax_package(tmp_path, monkeypatch, fmt, prefix):
    # the JAX random init of the rest compiles flax's init (~20 s); the
    # embedding reads only the snapshot's encoder, so its shape-faithful
    # init without a compile stands in
    monkeypatch.setattr(jcommon, "init_said_params", jcommon.fast_init)
    sd = hf_state_dict(prefix)
    if fmt == "safetensors":
        save_file(sd, str(tmp_path / "model.safetensors"))
    else:
        torch.save(sd, tmp_path / "pytorch_model.bin")
    pm = load_said_weights(SAID(audio_config=Wav2Vec2Config.tiny()).eval(), str(tmp_path), seed=0)
    for k, v in pm.audio_encoder.state_dict().items():
        assert torch.equal(v, sd[prefix + k]), k
    jm = JSAID(audio_config=JCfg.tiny())
    params = jcommon.load_said_params(str(tmp_path), jm, seed=0)
    wave = (np.random.default_rng(1).standard_normal((1, 6400)) * 0.3).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(wave), 24, method=JSAID.get_audio_embedding))
    with torch.no_grad():
        got = pm.get_audio_embedding(torch.from_numpy(wave), 24).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the rest is random from the seed, as without a snapshot
    ref = load_said_weights(SAID(audio_config=Wav2Vec2Config.tiny()), "", seed=0).state_dict()
    for k, v in pm.state_dict().items():
        if not k.startswith("audio_encoder."):
            assert torch.equal(v, ref[k]), k


def test_safetensors_reader_matches_the_package(tmp_path):
    tensors = {"f32": torch.randn(3, 4), "f16": torch.randn(5).half(), "bf16": torch.randn(2, 3).bfloat16(),
               "i64": torch.arange(7), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got, want = read_safetensors(str(tmp_path / "a.safetensors")), load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 12)
    with pytest.raises(ValueError, match="runs past"):
        read_safetensors(str(tmp_path / "bad.safetensors"))


def test_orbax_directory_and_incomplete_snapshot_are_refused(tmp_path):
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    (orbax / "checkpoint").write_text("{}")
    model = SAID(audio_config=Wav2Vec2Config.tiny())
    with pytest.raises(ValueError, match="JAX checkpoint format"):
        load_said_weights(model, str(orbax))
    with pytest.raises(SystemExit, match="JAX checkpoint format"):
        train.main(["--device", "cpu", "--audio_dir", str(tmp_path), "--coeffs_dir", str(tmp_path),
                    "--init_weights", str(orbax)])
    partial = {k: v for k, v in hf_state_dict("wav2vec2.").items() if ".layers.0." not in k}
    save_file(partial, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="lacks audio-encoder tensors"):
        load_said_weights(model, str(tmp_path))
