"""The port's training CLI on the CPU, as tests/test_cli_train.py drives the
JAX one, at the tiny test encoder's width.

The runs happen in a subprocess in which ``jax``, ``flax``, ``pandas``,
``triton`` and the JAX package ``said_tpu`` cannot be imported (the
machine with the card has none of the first four, and the port depends
on nothing of the fifth): two epochs with validation, a checkpoint and a
``.pth`` export, then a resume from that checkpoint for one more epoch.
The ``.pth`` then loads with ``strict=True`` into the port's model and
generates. The toy tree is written by the JAX package's own savers.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from said_tpu.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TRAIN, PERSON_IDS_VAL
from said_tpu.utils.audio import save_audio
from said_tpu.utils.blendshape import save_blendshape_coeffs
from said_tpu_torch.cli import train as train_cli
from said_tpu_torch.cli._common import load_said_weights
from said_tpu_torch.models.said import SAID, SAIDPipeline, process_audio
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

REPO = pathlib.Path(__file__).resolve().parent.parent
# tests/test_cli_train.py's TINY_AUDIO
TINY = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, output_hidden_size=32)

_BLOCKED_TRAIN = textwrap.dedent(
    """
    import importlib, json, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "flax", "pandas", "triton", "said_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import said_tpu_torch
    for mod in pkgutil.walk_packages(said_tpu_torch.__path__, "said_tpu_torch."):
        importlib.import_module(mod.name)
    from said_tpu_torch.cli import train
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    tiny = Wav2Vec2Config(**json.loads(sys.argv[1]))
    train.build_said_model = lambda prediction_type, feature_dim, dtype, remat: SAID(
        audio_config=tiny, prediction_type=prediction_type, remat=remat)
    for argv in json.loads(sys.argv[2]):
        train.main(argv)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pandas", "triton", "said_tpu"))
    assert not leaked, leaked
    """
)


@pytest.fixture(scope="module")
def toy_train_tree(tmp_path_factory):
    """tests/test_cli_train.py's tree: 2 train persons and 1 val person, 2
    sentences of 130 frames each."""
    root = tmp_path_factory.mktemp("blendvoca_train")
    audio_dir, coeffs_dir = root / "audio", root / "blendshape_coeffs"
    rng = np.random.default_rng(0)
    for pid in PERSON_IDS_TRAIN[:2] + PERSON_IDS_VAL[:1]:
        (audio_dir / pid).mkdir(parents=True)
        (coeffs_dir / pid).mkdir(parents=True)
        for sid in [1, 2]:
            n = 130
            save_audio(str(audio_dir / pid / f"sentence{sid:02}.wav"),
                       (0.1 * rng.standard_normal(n * 16000 // 60)).astype(np.float32), 16000)
            save_blendshape_coeffs(rng.uniform(0, 1, (n, 32)).astype(np.float32), BLENDSHAPE_CLASSES,
                                   str(coeffs_dir / pid / f"sentence{sid:02}.csv"))
    return str(audio_dir), str(coeffs_dir)


def _run(runs):
    # one intra-op thread: tiny shapes, and a parallel test run shares the cores
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN, json.dumps(TINY), json.dumps(runs)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _metrics(out_dir):
    return [json.loads(line) for line in (pathlib.Path(out_dir) / "SAiD" / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_two_epochs_then_resume(toy_train_tree, tmp_path):
    """Two epochs (validation and a checkpoint at epoch 2, the EMA exported
    as 2.pth), then ``--resume`` from that checkpoint for one epoch: the
    metrics file holds three lines, the resumed run starts at step 2."""
    audio_dir, coeffs_dir = toy_train_tree
    out_dir = str(tmp_path / "out")
    common = ["--device", "cpu", "--audio_dir", audio_dir, "--coeffs_dir", coeffs_dir, "--output_dir", out_dir,
              "--batch_size", "2", "--num_warmup_epochs", "1", "--val_repeat", "1", "--window_bucket", "8"]
    stdout = _run([common + ["--epochs", "2", "--val_period", "2", "--save_period", "2"],
                   common + ["--epochs", "1", "--val_period", "1000", "--save_period", "1000", "--export_pth", "",
                             "--resume", str(pathlib.Path(out_dir) / "ckpt" / "2")]])
    assert "at step 4" in stdout  # 2 steps an epoch (4 clips, batch 2) × 2 epochs
    lines = _metrics(out_dir)
    assert [line["step"] for line in lines] == [1, 2, 1]
    assert all(np.isfinite(line["Train/loss"]) and line["Train/nan_skipped"] == 0.0 for line in lines)
    assert "Validation/loss" in lines[1] and np.isfinite(lines[1]["Validation/loss"])
    assert "Validation/loss" not in lines[0] and "Validation/loss" not in lines[2]
    assert (pathlib.Path(out_dir) / "ckpt" / "2" / "train_state.pt").exists()

    # the exported EMA weights load strictly and generate
    model = load_said_weights(SAID(audio_config=Wav2Vec2Config(**TINY)), str(pathlib.Path(out_dir) / "2.pth"))
    state = torch.load(pathlib.Path(out_dir) / "ckpt" / "2" / "train_state.pt", weights_only=True)
    assert state["step"] == 4 and state["optimizer"]["count"] == 4
    for name, ema in state["ema"].items():
        torch.testing.assert_close(model.state_dict()[name], ema, rtol=0, atol=0)
    wave = process_audio(0.1 * np.random.default_rng(1).standard_normal(6400).astype(np.float32))
    out = SAIDPipeline(model.eval()).inference(wave, num_inference_steps=3, guidance_scale=2.0,
                                               generator=torch.Generator().manual_seed(0)).result
    assert out.shape == (1, 24, 32) and np.isfinite(out).all()


def test_train_cli_flags_follow_the_jax_cli():
    """The JAX CLI's flags and defaults (said_tpu/cli/train.py:63-135),
    plus ``--device``; the data paths are required and the output
    directory lies in the working directory."""
    import said_tpu.cli.train as jcli

    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    train_cli.add_arguments(ours)
    jcli.add_arguments(theirs)
    with pytest.raises(SystemExit):
        ours.parse_args([])
    paths = ["--audio_dir", "a", "--coeffs_dir", "c"]
    mine, want = vars(ours.parse_args(paths)), vars(theirs.parse_args(paths))
    assert mine.pop("device") == "cuda"
    assert mine.pop("output_dir") == "output" and want.pop("output_dir") == "../output"
    assert mine == want


@pytest.mark.parametrize("flag", ["--mesh_data", "--mesh_model", "--mesh_seq"])
def test_train_cli_refuses_sharding(flag, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 13"):
        train_cli.main(["--device", "cpu", flag, "2", "--audio_dir", str(tmp_path), "--coeffs_dir", str(tmp_path),
                        "--output_dir", str(tmp_path)])
