"""The port's CLI and import hygiene, on the CPU.

The CLI runs in a subprocess in which ``jax``, ``flax`` and ``pandas``
cannot be imported (the machine with the card has none of them): every
module of ``said_tpu_torch`` is imported there first, then
``said_tpu_torch.cli.inference --device cpu --num_steps 3`` turns a
0.8-s WAV into a CSV of 48 rows under the 32 ARKit names.
"""

import argparse
import csv
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from said_tpu_torch.cli import inference
from said_tpu_torch.cli._common import (
    ARKIT_BLENDSHAPES,
    load_blendshape_coeffs,
    load_said_weights,
    save_blendshape_coeffs,
)
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "flax", "pandas", "triton"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import said_tpu_torch
    for mod in pkgutil.walk_packages(said_tpu_torch.__path__, "said_tpu_torch."):
        importlib.import_module(mod.name)
    from said_tpu_torch.cli import inference
    inference.main(sys.argv[1:])
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pandas", "triton"))
    assert not leaked, leaked
    """
)


def test_cli_runs_without_jax_flax_pandas(tmp_path):
    from scipy.io import wavfile

    t = np.arange(12800) / 16000
    wav = tmp_path / "clip.wav"
    wavfile.write(wav, 16000, (0.3 * np.sin(2 * np.pi * 300 * t) * 32767).astype(np.int16))
    out = tmp_path / "out.csv"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, "--device", "cpu", "--num_steps", "3",
         "--weights_path", "", "--audio_path", str(wav), "--output_path", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert tuple(rows[0]) == ARKIT_BLENDSHAPES
    coeffs = np.asarray(rows[1:], dtype=np.float64)
    assert coeffs.shape == (48, 32)
    assert np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0
    assert coeffs.std() > 1e-3


def test_arkit_names_follow_the_asset_file():
    names = (REPO / "said_tpu" / "data" / "assets" / "ARKit_blendshapes.txt").read_text().split()
    assert tuple(names) == ARKIT_BLENDSHAPES


def test_csv_round_trip(tmp_path):
    coeffs = np.random.default_rng(0).uniform(0, 1, (5, 32)).astype(np.float32)
    path = tmp_path / "c.csv"
    save_blendshape_coeffs(coeffs, ARKIT_BLENDSHAPES, str(path))
    np.testing.assert_array_equal(load_blendshape_coeffs(str(path)), coeffs)


@pytest.mark.parametrize(
    "flags,item",
    [
        (["--solver", "dpmpp_2m"], "Queue 1 item 9"),
        (["--length_bucket", "120"], "Queue 1 item 8"),
        (["--streaming_window", "3600"], "Queue 1 item 9"),
        (["--seq_shards", "2"], "Queue 1 item 13"),
        (["--attn_impl", "flash"], "K1"),
        (["--attn_impl", "flash_sp"], "K1"),
    ],
)
def test_unported_options_fail_loudly(flags, item):
    with pytest.raises(SystemExit, match=item):
        inference.main(["--device", "cpu", *flags])


def test_defaults_stay_in_the_working_directory():
    parser = argparse.ArgumentParser()
    inference.add_arguments(parser)
    args = parser.parse_args([])
    for name in ("weights_path", "audio_path", "output_path", "output_image_path", "intermediate_dir"):
        value = getattr(args, name)
        assert ".." not in value and not os.path.isabs(value), (name, value)
    assert args.weights_path == ""


def test_audio_path_is_required(capsys):
    with pytest.raises(SystemExit):
        inference.main(["--device", "cpu"])
    assert "--audio_path is required" in capsys.readouterr().err


def test_missing_weights_file_raises(tmp_path):
    model = SAID(audio_config=Wav2Vec2Config.tiny())
    with pytest.raises(FileNotFoundError, match="no_such.pth"):
        load_said_weights(model, str(tmp_path / "no_such.pth"))


def test_no_library_kernels_in_the_port():
    src = "\n".join(p.read_text() for p in (REPO / "said_tpu_torch").rglob("*.py"))
    for banned in ("scaled_dot_product_attention", "torch.compile", "import jax", "import flax", "import pandas"):
        assert banned not in src, banned
