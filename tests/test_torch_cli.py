"""The port's CLI and import hygiene, on the CPU.

The CLIs run in a subprocess in which ``jax``, ``flax``, ``pandas``,
``sklearn`` and the JAX package ``said_tpu`` cannot be imported (the
machine with the card has none of the first four, and the port depends on
nothing of the fifth): every module of ``said_tpu_torch`` is imported
there first, then ``said_tpu_torch.cli.inference --device cpu --num_steps
3`` turns a 0.8-s WAV into a CSV of 48 rows under the 32 ARKit names,
``said_tpu_torch.cli.test_inference`` turns a one-clip test split into
its CSVs, and ``train_vae``, ``inference_vae`` and ``test_evaluate`` run
in turn on toy data.
"""

import argparse
import csv
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from said_tpu_torch.cli import (
    inference,
    optimize_blendshape_coeffs,
    preprocess_blendvoca,
    render,
    test_inference,
    test_render,
)
from said_tpu_torch.cli._common import (
    ARKIT_BLENDSHAPES,
    load_blendshape_coeffs,
    load_said_weights,
    save_blendshape_coeffs,
)
from said_tpu.data import blendvoca as jblendvoca
from said_tpu.utils import audio as jaudio
from said_tpu_torch.data import blendvoca
from said_tpu_torch.models.said import SAID, SAIDPipeline, process_audio
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.utils import audio

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "flax", "pandas", "sklearn", "triton", "said_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import said_tpu_torch
    for mod in pkgutil.walk_packages(said_tpu_torch.__path__, "said_tpu_torch."):
        importlib.import_module(mod.name)
    # argv: <cli> <args...> [--then <cli> <args...>]...
    argv = sys.argv[1:]
    while argv:
        cut = argv.index("--then") if "--then" in argv else len(argv)
        cli = importlib.import_module("said_tpu_torch.cli." + argv[0])
        cli.main(argv[1:cut])
        argv = argv[cut + 1 :]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    """
)


def test_cli_runs_without_jax_flax_pandas(tmp_path):
    """(and without ``said_tpu``)"""
    from scipy.io import wavfile

    t = np.arange(12800) / 16000
    wav = tmp_path / "clip.wav"
    wavfile.write(wav, 16000, (0.3 * np.sin(2 * np.pi * 300 * t) * 32767).astype(np.int16))
    out = tmp_path / "out.csv"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, "inference", "--device", "cpu", "--num_steps", "3",
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


def test_vae_clis_run_without_jax_flax_pandas_sklearn(tmp_path):
    """(and without ``said_tpu``): ``train_vae`` for one epoch on a toy
    tree, ``inference_vae`` on one of its CSVs, ``test_evaluate`` on a
    one-clip split with generated = real + noise."""
    from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TRAIN

    rng = np.random.default_rng(0)
    pid = blendvoca.PERSON_IDS_TEST[0]
    for sub, person, name in (("coeffs", PERSON_IDS_TRAIN[0], "sentence01.csv"), ("real", pid, "sentence01.csv"),
                              ("gen", pid, "sentence01-0.csv"), ("gen", pid, "sentence01-1.csv")):
        (tmp_path / sub / person).mkdir(parents=True, exist_ok=True)
        save_blendshape_coeffs(rng.uniform(0, 1, (130, 32)).astype(np.float32), BLENDSHAPE_CLASSES,
                               str(tmp_path / sub / person / name))
    _test_split(tmp_path / "audio", [[130 / 60]])
    csv_in = str(tmp_path / "coeffs" / PERSON_IDS_TRAIN[0] / "sentence01.csv")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN,
         "train_vae", "--device", "cpu", "--coeffs_dir", str(tmp_path / "coeffs"), "--output_dir",
         str(tmp_path / "vae_out"), "--epochs", "1", "--batch_size", "2", "--save_period", "1", "--then",
         "inference_vae", "--device", "cpu", "--blendshape_coeffs_path", csv_in, "--output_path",
         str(tmp_path / "recon.csv"), "--then",
         "test_evaluate", "--device", "cpu", "--audio_dir", str(tmp_path / "audio"), "--coeffs_dir",
         str(tmp_path / "gen"), "--coeffs_real_dir", str(tmp_path / "real"), "--wind_num_clusters", "2",
         "--wind_num_repeats", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "vae_out" / "ckpt" / "1" / "train_state.pt").is_file()
    assert _read_csv(tmp_path / "recon.csv").shape == (120, 32)
    metrics = proc.stdout.strip().splitlines()[-1]
    assert "frechet_distance" in metrics and "wind" in metrics


def _write_wav(path, seconds=0.4):
    from scipy.io import wavfile

    t = np.arange(int(seconds * 16000)) / 16000
    wave = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    wavfile.write(path, 16000, (wave * 32767).astype(np.int16))


def _test_split(root, seconds):
    """A toy test split: ``seconds[p][s]`` is the length of person p's
    sentence s + 1."""
    for pid, lengths in zip(blendvoca.PERSON_IDS_TEST, seconds):
        (root / pid).mkdir(parents=True)
        for sid, sec in enumerate(lengths, start=1):
            _write_wav(root / pid / f"sentence{sid:02}.wav", sec)
    return root


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert tuple(rows[0]) == ARKIT_BLENDSHAPES
    return np.asarray(rows[1:], dtype=np.float64)


def _processed_wave(path):
    return process_audio(audio.fit_audio_unet(audio.load_audio(str(path), 16000), 16000, 60, 1).waveform)


def test_test_inference_runs_without_jax_flax_pandas(tmp_path):
    """(and without ``said_tpu``): the full-width model, one clip, 2 steps"""
    audio = _test_split(tmp_path / "audio", [[0.3]])
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, "test_inference", "--device", "cpu", "--num_steps", "2",
         "--num_repeats", "2", "--batch_size", "2", "--audio_dir", str(audio), "--output_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for k in range(2):
        coeffs = _read_csv(out / blendvoca.PERSON_IDS_TEST[0] / f"sentence01-{k}.csv")
        assert coeffs.shape == (18, 32)
        assert np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0


@pytest.mark.parametrize("mixed", [False, True], ids=["per_clip", "mixed_batching"])
def test_test_inference_writes_every_sample(tmp_path, monkeypatch, mixed):
    """Two persons × two sentences (18, 27, 21 and 12 frames, one 16-frame
    bucket or two), three samples each in batches of two: every CSV holds
    its clip's real rows in [0, 1]; per clip, the CSVs equal the same
    requests made straight through ``SAIDPipeline`` with one generator."""
    def tiny(*args, **kwargs):
        return SAID(audio_config=Wav2Vec2Config.tiny())

    monkeypatch.setattr(test_inference, "build_said_model", tiny)
    seconds = [[0.3, 0.45], [0.35, 0.2]]
    audio = _test_split(tmp_path / "audio", seconds)
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--num_steps", "2", "--num_repeats", "3", "--batch_size", "2",
            "--length_bucket", "16", "--audio_dir", str(audio), "--output_dir", str(out)]
    written = test_inference.main(argv + (["--mixed_batching"] if mixed else []))
    assert len(written) == 12
    for pid, lengths in zip(blendvoca.PERSON_IDS_TEST, seconds):
        for sid, sec in enumerate(lengths, start=1):
            for k in range(3):
                coeffs = _read_csv(out / pid / f"sentence{sid:02}-{k}.csv")
                assert coeffs.shape == (int(sec * 60), 32)
                assert np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0
                assert coeffs.std() > 1e-3
    if mixed:
        return
    pipe = SAIDPipeline(load_said_weights(tiny(), "", seed=0).eval())
    gen = torch.Generator().manual_seed(0)
    for pid, lengths in zip(blendvoca.PERSON_IDS_TEST, seconds):
        for sid, sec in enumerate(lengths, start=1):
            wave = _processed_wave(audio / pid / f"sentence{sid:02}.wav")
            got = [load_blendshape_coeffs(str(out / pid / f"sentence{sid:02}-{k}.csv")) for k in range(3)]
            for lo, n in ((0, 2), (2, 1)):
                want = pipe.inference(np.repeat(wave, n, axis=0), num_inference_steps=2, guidance_scale=2.0,
                                      generator=gen, length_bucket=16).result[:, : int(sec * 60)]
                np.testing.assert_array_equal(np.stack(got[lo : lo + n]), want)


def test_test_inference_mixed_needs_a_bucket(tmp_path):
    with pytest.raises(SystemExit, match="length_bucket"):
        test_inference.main(["--device", "cpu", "--audio_dir", str(tmp_path), "--mixed_batching",
                             "--length_bucket", "0"])


def test_test_split_matches_the_jax_package(tmp_path):
    """Subjects, sentences, discovery order, and the CSV columns: the
    port's ARKit names are the JAX package's BLENDSHAPE_CLASSES, in order."""
    assert blendvoca.PERSON_IDS_TEST == jblendvoca.PERSON_IDS_TEST
    assert blendvoca.SENTENCE_IDS == jblendvoca.SENTENCE_IDS
    assert tuple(jblendvoca.BLENDSHAPE_CLASSES) == ARKIT_BLENDSHAPES
    audio = _test_split(tmp_path / "audio", [[0.1, 0.1, 0.1], [0.1]])
    (audio / blendvoca.PERSON_IDS_TEST[0] / "sentence02.wav").unlink()
    got = [(p.person_id, p.sentence_id, p.audio) for p in blendvoca.get_data_paths(str(audio))]
    want = [(p.person_id, p.sentence_id, p.audio)
            for p in jblendvoca.get_data_paths(str(audio), None, jblendvoca.PERSON_IDS_TEST)]
    assert got == want and len(got) == 3


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
        (["--streaming_window", "600", "--length_bucket", "120"],
         "--length_bucket is not supported with --streaming_window"),
        (["--seq_shards", "2"], "Queue 1 item 13"),
        (["--attn_impl", "flash_sp"], "Queue 1 item 13"),
    ],
)
def test_unported_options_fail_loudly(flags, item):
    with pytest.raises(SystemExit, match=item):
        inference.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("flags,message", [
    (["--init_sample_path", "init.csv"], "--init_sample_path is not supported with --streaming_window"),
    (["--mask_path", "mask.csv"], "--mask_path is not supported with --streaming_window"),
    (["--save_intermediate", "true"], "--save_intermediate is not supported with --streaming_window"),
    (["--seq_shards", "2"], "--seq_shards is not supported with --streaming_window"),
    (["--strength", "0.5"], "--strength is not supported with --streaming_window"),
], ids=["init_sample_path", "mask_path", "save_intermediate", "seq_shards", "strength"])
def test_streaming_refusals_match_the_jax_cli(flags, message):
    """said_tpu/cli/inference.py:166-178's refusals, word for word."""
    with pytest.raises(SystemExit, match=message):
        inference.main(["--device", "cpu", "--streaming_window", "600", *flags])


@pytest.mark.parametrize(
    "flags,kw",
    [(["--solver", "dpmpp_2m"], {"solver": "dpmpp_2m"}), (["--attn_impl", "flash"], {}),
     (["--length_bucket", "16"], {"length_bucket": 16}),
     (["--streaming_window", "12", "--streaming_overlap", "3"], {"window_frames": 12, "overlap_frames": 3})],
    ids=["dpmpp_2m", "attn_flash", "length_bucket", "streaming_window"],
)
def test_ported_options_run(tmp_path, monkeypatch, flags, kw):
    """``--solver dpmpp_2m`` reaches the sampler, ``--attn_impl flash``
    routes as ``auto`` and ``--streaming_window`` serves the clip as
    windows (24 frames as 12-frame windows at 0, 9 and 12): the CSV equals
    the same request made straight through ``SAIDPipeline`` (tiny encoder,
    0.4-s clip, 3 steps)."""
    def tiny(*args, **kwargs):
        return SAID(audio_config=Wav2Vec2Config.tiny())

    monkeypatch.setattr(inference, "build_said_model", tiny)
    wav, out = tmp_path / "clip.wav", tmp_path / "out.csv"
    _write_wav(wav)
    got = inference.main(["--device", "cpu", "--num_steps", "3", "--audio_path", str(wav),
                          "--output_path", str(out), *flags])
    pipe = SAIDPipeline(load_said_weights(tiny(), "", seed=0).eval())
    wave = process_audio(audio.fit_audio_unet(audio.load_audio(str(wav), 16000), 16000, 60, 1).waveform)
    run = pipe.inference_streaming if "window_frames" in kw else pipe.inference
    want = run(wave, num_inference_steps=3, guidance_scale=2.0, generator=torch.Generator().manual_seed(0),
               **kw).result[0, :24]
    np.testing.assert_array_equal(got, want)
    assert load_blendshape_coeffs(str(out)).shape == (24, 32)


@pytest.mark.parametrize("sr,channels,dtype", [(16000, 1, np.int16), (22050, 2, np.int16),
                                               (8000, 1, np.float32), (44100, 1, np.int32)])
def test_audio_io_matches_the_jax_package(tmp_path, sr, channels, dtype):
    """The port's copy of load_audio/resample/fit_audio_unet equals
    ``said_tpu.utils.audio`` bit for bit."""
    from scipy.io import wavfile

    rng = np.random.default_rng(sr)
    x = rng.uniform(-0.5, 0.5, (int(0.37 * sr), channels)).squeeze()
    if dtype != np.float32:
        x = x * np.iinfo(dtype).max
    path = str(tmp_path / "a.wav")
    wavfile.write(path, sr, x.astype(dtype))
    got, want = audio.load_audio(path, 16000), jaudio.load_audio(path, 16000)
    np.testing.assert_array_equal(got, want)
    for divisor in (1, 3):
        fg, fw = audio.fit_audio_unet(got, 16000, 60, divisor), jaudio.fit_audio_unet(want, 16000, 60, divisor)
        assert fg.window_size == fw.window_size
        np.testing.assert_array_equal(fg.waveform, fw.waveform)


def _imports(*modules):
    """An import statement of any of ``modules`` (or of a submodule), at
    any indent; a comment or a string that names one does not match."""
    names = "|".join(map(re.escape, modules))
    return re.compile(rf"^\s*(from|import)\s+({names})(\.|\s|,|$)", re.M)


def test_port_imports_nothing_of_the_jax_package():
    """Nor jax, flax, pandas, sklearn or safetensors (the machine with the
    card has none), anywhere in the port or ``chip_smoke.py``; nor PIL in
    the render and asset paths."""
    port = REPO / "said_tpu_torch"
    sources = [*port.rglob("*.py"), REPO / "chip_smoke.py"]
    pattern = _imports("said_tpu", "jax", "flax", "pandas", "sklearn", "safetensors")
    for path in sources:
        assert not pattern.search(path.read_text()), path
    no_pil = [*(port / "render").rglob("*.py"), port / "utils" / "blendshape.py", port / "utils" / "png.py",
              *(port / "cli" / f"{name}.py" for name in ("preprocess_blendvoca", "optimize_blendshape_coeffs",
                                                          "render", "test_render"))]
    for path in no_pil:
        assert path.is_file() and not _imports("PIL").search(path.read_text()), path
    assert _imports("jax").search("x = 1\n    import jax.numpy as jnp\n")
    assert _imports("PIL").search("from PIL import Image")
    assert not _imports("jax", "said_tpu").search("# jax and said_tpu are not imported\nimport said_tpu_torch\n")


@pytest.mark.parametrize("cli,names", [
    (inference, ("weights_path", "audio_path", "output_path", "output_image_path", "intermediate_dir")),
    (test_inference, ("weights_path", "audio_dir", "output_dir")),
    (preprocess_blendvoca, ("templates_dir", "blendshape_deltas_path", "blendshapes_out_dir", "neutrals_dir",
                            "blendshapes_dir")),
    (optimize_blendshape_coeffs, ("neutrals_dir", "blendshapes_dir", "mesh_seqs_dir", "output_dir")),
    (render, ("neutral_path", "blendshapes_dir", "audio_path", "blendshape_coeffs_path", "output_images_dir",
              "output_path")),
    (test_render, ("audio_dir", "coeffs_dir", "neutrals_dir", "blendshapes_dir", "output_dir")),
], ids=["inference", "test_inference", "preprocess_blendvoca", "optimize_blendshape_coeffs", "render",
        "test_render"])
def test_defaults_stay_in_the_working_directory(cli, names):
    """(the asset tables' defaults are the port's own files)"""
    parser = argparse.ArgumentParser()
    cli.add_arguments(parser)
    args = parser.parse_args([])
    for name in names:
        value = getattr(args, name)
        assert ".." not in value and not os.path.isabs(value), (name, value)
    for name in ("blendshape_list_path", "head_idx_path"):
        if hasattr(args, name):
            assert os.path.isfile(getattr(args, name)) and "said_tpu_torch" in getattr(args, name), name
    if hasattr(args, "weights_path"):
        assert args.weights_path == ""
    if hasattr(args, "device"):
        assert args.device == "cuda"


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
    for banned in ("scaled_dot_product_attention", "torch.compile", "import jax", "import flax", "import pandas",
                   "import sklearn", "from sklearn"):
        assert banned not in src, banned
