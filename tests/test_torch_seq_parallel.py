"""Sequence-parallel serving of the port on the CPU: gloo ranks against one
process and against the JAX package's ``seq_mesh``.

The ranks are ``python -m torch.distributed.run --nproc_per_node {2,4}``
processes running ``tests/torch_parallel_worker.py seq`` (one launch per
world size, its results read by a module-scoped fixture); the unsharded
references are computed here. Inputs come from the worker's seeded
makers. Bounds: the frame-sharded attention against dense attention at
atol 2e-5, rtol 1e-4, and the pipeline against JAX at atol 1e-4, rtol
1e-3, as ``tests/test_seq_parallel.py`` holds the JAX package to itself;
the sharded GroupNorm twin against the unsharded ones at atol 4e-5, rtol
1e-5 (``tests/test_torch_group_norm.py``'s bound for f32 versions at
mean 30, std 2: each sits within 2.3e-5 of a float64 evaluation, pairs
differ by up to ~3.3e-5) and against float64 at atol 2.5e-5; the convs'
halos at atol 1e-6, rtol 1e-6 (the same products of the same values);
the encoder and the UNet at atol 5e-5, rtol 1e-4 (the local flash
attention is the plain flash version, the unsharded one dense); the
CLI's CSV within 1e-4.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_worker as worker
from said_tpu.cli._common import fast_init
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.said import SAIDPipeline as JPipeline
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu.ops.norms import _group_norm_jnp
from said_tpu.ops.pallas_attention import _dense_flat
from said_tpu.utils.audio import save_audio
from said_tpu_torch.cli import inference
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID, SAIDPipeline
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.ops.attention import flash_attention_flat_sp
from said_tpu_torch.ops.norms import group_norm_plain
from said_tpu_torch.parallel.mesh import AxisGroup

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLDS = [2, 4]
CLIP_SAMPLES = 12800  # 0.8 s: 48 frames, even, so --seq_shards 2 pads nothing


def launch(n, work, suite):
    """Run ``suite`` of the worker on n gloo ranks; each rank's results."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={n}",
           str(REPO / "tests" / "torch_parallel_worker.py"), suite, str(work)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [torch.load(work / f"{suite}_rank{r}.pt", weights_only=False) for r in range(n)]


def _jax_model():
    jm = JSAID(audio_config=JCfg(**worker.SP_AUDIO), self_attn_impl="flash_sp", encoder_attn_impl="flash_sp")
    return jm, jax.tree.map(np.asarray, fast_init(jm, 0))


def _cli_argv(work, out, *flags):
    return ["--device", "cpu", "--num_steps", "3", "--guidance_scale", "2.0", "--weights_path",
            str(work / "said.pth"), "--audio_path", str(work / "clip.wav"), "--output_path", str(out), *flags]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: each rank's results}, one launch per world size."""
    results = {}
    for n in WORLDS:
        work = tmp_path_factory.mktemp(f"sp{n}")
        if n == 2:
            _, params = _jax_model()
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in said_state_dict(params).items()},
                       work / "said.pth")
            save_audio(str(work / "clip.wav"), worker.rand((CLIP_SAMPLES,), 60, 0.1), 16000)
            (work / "cli_argv.json").write_text(json.dumps(_cli_argv(work, work / "sp.csv", "--seq_shards", "2")))
        results[n] = (launch(n, work, "seq"), work)
    return results


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _every_rank(ranks, n, key):
    """The gathered result of ``key``, the same on every rank."""
    outs = [r[key] for r in ranks[n][0]]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("n", WORLDS)
def test_flash_attention_flat_sp_matches_dense(ranks, n):
    q, k, v = worker.attention_inputs()
    want = _dense_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), worker.ATTN["heads"])
    _close(_every_rank(ranks, n, "attention"), want, 2e-5, 1e-4)


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("n", WORLDS)
def test_group_norm_sharded_matches_unsharded(ranks, n, act):
    x, w, b = worker.group_norm_inputs()
    got = _every_rank(ranks, n, f"group_norm_{act}")
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    _close(got, group_norm_plain(tx, 32, tw, tb, 1e-6, act), 4e-5, 1e-5)
    _close(got, _group_norm_jnp(jnp.asarray(x), 32, jnp.asarray(w), jnp.asarray(b), 1e-6, act), 4e-5, 1e-5)
    xd = tx.double().reshape(2, -1, 32, 6)
    want = ((xd - xd.mean((1, 3), keepdim=True)) / torch.sqrt(xd.var((1, 3), keepdim=True, correction=0) + 1e-6))
    want = want.reshape(x.shape) * tw.double() + tb.double()
    _close(got, want * torch.sigmoid(want) if act == "silu" else want, 2.5e-5, 0)


@pytest.mark.parametrize("n", WORLDS)
def test_conv3_halo(ranks, n):
    """The k=3 SAME conv of 300 or 150 frames a rank, with a halo of 1."""
    with torch.no_grad():
        want = worker.make_conv3()(torch.from_numpy(worker.rand((2, worker.CONV_T, 64), 46)))
    _close(_every_rank(ranks, n, "conv3"), want, 1e-6, 1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_positional_conv_halo(ranks, n):
    """wav2vec2's k=128 positional conv of 300 or 150 frames a rank (no
    multiple of 64): halos of 64 and 63 frames, the trailing frame of the
    even kernel dropped once, at the clip's end."""
    with torch.no_grad():
        want = worker.make_pos_conv()(torch.from_numpy(worker.rand((2, worker.CONV_T, 32), 47)))
    _close(_every_rank(ranks, n, "pos_conv"), want, 1e-6, 1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_encoder_sharded_matches_unsharded(ranks, n):
    with torch.no_grad():
        want = worker.make_encoder()(torch.from_numpy(worker.sp_wave()), worker.SP_FRAMES)
    _close(_every_rank(ranks, n, "encoder"), want, 5e-5, 1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_unet_sharded_matches_unsharded(ranks, n):
    sample, context, ts = (torch.from_numpy(a) for a in worker.unet_inputs())
    with torch.no_grad():
        want = worker.make_unet()(sample, ts, context)
    _close(_every_rank(ranks, n, "unet"), want, 5e-5, 1e-4)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp_2m"])
def test_pipeline_matches_jax_seq_mesh(ranks, solver):
    """2 ranks, 4 steps, CFG 2.0, injected latents, against the JAX
    pipeline on a 2-device 'seq' mesh with the same weights."""
    jm, params = _jax_model()
    want = JPipeline(jm, params).inference(
        waveform_processed=worker.sp_wave(), num_inference_steps=4, guidance_scale=2.0, solver=solver,
        latents=worker.sp_latents(), seq_mesh=Mesh(np.asarray(jax.devices()[:2]), ("seq",))).result
    got = _every_rank(ranks, 2, f"pipeline_{solver}")
    assert got.shape == (1, worker.SP_FRAMES, 32) and got.std() > 1e-3
    _close(got, want, 1e-4, 1e-3)


def test_pipeline_editing_matches_one_process(ranks):
    """Editing on 2 ranks (inits, a mask, strength 0.6, DDIM with eta 0.5:
    the eta and editing noise drawn for the whole clip from a generator
    seeded alike, each rank keeping its frames) equals one process."""
    _, work = ranks[2]
    model = SAID(audio_config=Wav2Vec2Config(**worker.SP_AUDIO))
    model.load_state_dict(torch.load(work / "said.pth", weights_only=True), strict=True)
    want = SAIDPipeline(model.eval()).inference(worker.sp_wave(), **worker.sp_edit_request()).result
    got = _every_rank(ranks, 2, "pipeline_edit")
    assert got.std() > 1e-3
    _close(got, want, 1e-4, 1e-3)


def test_cli_seq_shards_matches_one_process(ranks, monkeypatch):
    """``--seq_shards 2`` under torchrun writes (rank 0) the CSV one process
    writes, within 1e-4."""
    results, work = ranks[2]
    monkeypatch.setattr(inference, "build_said_model", lambda *a, **kw: SAID(audio_config=Wav2Vec2Config(
        **worker.SP_AUDIO)))
    want = inference.main(_cli_argv(work, work / "one.csv"))
    assert want.shape == (48, 32)
    np.testing.assert_allclose(_every_rank(ranks, 2, "cli"), want, atol=1e-4, rtol=0)
    from said_tpu_torch.utils.blendshape import load_blendshape_coeffs

    np.testing.assert_allclose(load_blendshape_coeffs(str(work / "sp.csv")), want, atol=1e-4, rtol=0)


def _pipelines():
    _, params = _jax_model()
    jm = JSAID(audio_config=JCfg(**worker.SP_AUDIO), self_attn_impl="flash_sp", encoder_attn_impl="flash_sp")
    pm = SAID(audio_config=Wav2Vec2Config(**worker.SP_AUDIO))
    return JPipeline(jm, params), SAIDPipeline(pm.eval())


@pytest.mark.parametrize("kw", [dict(length_bucket=64), dict()], ids=["length_bucket", "indivisible_frames"])
def test_pipeline_refusals_match_jax(kw):
    """A group of 3 ranks does not divide 128 frames, and SP excludes
    length buckets: the port raises JAX's errors (``seq_group`` for
    ``seq_mesh``) before any collective."""
    jpipe, pipe = _pipelines()
    devices = jax.devices()[:3]
    with pytest.raises(ValueError) as jerr:
        jpipe.inference(worker.sp_wave(), num_inference_steps=2, seq_mesh=Mesh(np.asarray(devices), ("seq",)), **kw)
    with pytest.raises(ValueError) as err:
        pipe.inference(worker.sp_wave(), num_inference_steps=2, seq_group=AxisGroup(None, 0, 3), **kw)
    assert str(err.value) == str(jerr.value).replace("seq_mesh", "seq_group")


def test_flash_attention_flat_sp_refusals():
    """JAX's refusal of runtime lengths; its gradient, once refused too, is
    held against dense attention in ``tests/test_torch_seq_parallel_train.py``
    (``test_flash_attention_flat_sp_gradient_matches_dense``)."""
    q = torch.zeros((1, 8, 64))
    group = AxisGroup(None, 0, 2)
    with pytest.raises(ValueError, match="flash_sp does not support runtime lengths"):
        flash_attention_flat_sp(q, q, q, 2, group, lengths=torch.ones(1, dtype=torch.int32))
