"""Data-parallel training of the port on the CPU: 2 gloo ranks against one
process and against the JAX package's data-sharded loss.

The ranks are one ``python -m torch.distributed.run --nproc_per_node 2``
launch of ``tests/torch_parallel_worker.py data`` (its results read by a
module-scoped fixture), at ``tests/test_multichip.py``'s tiny config with
weights from the JAX ``fast_init``:

- two train-mode steps (dropout, layerdrop, spec-augment, drawn
  timesteps and noise; a bucketed batch of 4, then one with std
  reweighting and blendshape deltas), each rank on 2 rows, against one
  process on the 4: the loss within 1e-6 relative, each gradient the
  optimizer receives (all-reduced, before the clip) within 1e-5 relative
  L2, and after each optimizer step and EMA update the parameters
  identical on both ranks;
- the deterministic loss (injected timesteps and noise) of a batch of 8,
  summed over the ranks, against JAX's ``said_loss`` over its 8-device
  CPU mesh, within 1e-5 relative (``tests/test_torch_train_loss.py``'s
  bound);
- the train CLI with ``--mesh_data 2`` against ``--mesh_data 1``, 2
  epochs on a tiny tree: the exported ``.pth`` within 1e-5 relative L2 a
  tensor, and only rank 0 wrote files.
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

import torch_parallel_worker as worker
from said_tpu.cli._common import fast_init
from said_tpu.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TRAIN, PERSON_IDS_VAL
from said_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu.parallel.mesh import MeshConfig, batch_sharding, make_mesh, shard_params
from said_tpu.train import said_train as jtrain
from said_tpu.utils.audio import save_audio
from said_tpu.utils.blendshape import save_blendshape_coeffs
from said_tpu_torch.cli import train as train_cli
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL, GRAD_REL_L2 = 1e-6, 1e-5


def _jax_params():
    jm = JSAID(audio_config=JCfg(**worker.DP_AUDIO))
    return jm, jax.tree.map(np.asarray, fast_init(jm, 0))


def _write_tree(root):
    """tests/test_cli_train.py's tree: 2 train persons and 1 val person, 2
    sentences of 130 frames each."""
    rng = np.random.default_rng(0)
    for pid in PERSON_IDS_TRAIN[:2] + PERSON_IDS_VAL[:1]:
        for sub in ("audio", "coeffs"):
            (root / sub / pid).mkdir(parents=True)
        for sid in (1, 2):
            save_audio(str(root / "audio" / pid / f"sentence{sid:02}.wav"),
                       (0.1 * rng.standard_normal(130 * 16000 // 60)).astype(np.float32), 16000)
            save_blendshape_coeffs(rng.uniform(0, 1, (130, 32)).astype(np.float32), BLENDSHAPE_CLASSES,
                                   str(root / "coeffs" / pid / f"sentence{sid:02}.csv"))


def _cli_argv(root, out, mesh_data):
    return ["--device", "cpu", "--audio_dir", str(root / "audio"), "--coeffs_dir", str(root / "coeffs"),
            "--output_dir", str(out), "--batch_size", "2", "--num_warmup_epochs", "1", "--val_repeat", "1",
            "--epochs", "2", "--val_period", "2", "--save_period", "2", "--mesh_data", str(mesh_data)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    _, params = _jax_params()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in said_state_dict(params).items()}, work / "said.pth")
    _write_tree(work)
    (work / "cli_argv.json").write_text(json.dumps(_cli_argv(work, work / "out2", 2)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           str(REPO / "tests" / "torch_parallel_worker.py"), "data", str(work)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [torch.load(work / f"data_rank{r}.pt", weights_only=False) for r in range(2)], work


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("step", [0, 1], ids=["bucketed_spec_augment", "std_and_deltas"])
def test_two_ranks_equal_one_in_train_mode(run, step):
    (r0, r1), _ = run
    np.testing.assert_allclose(r0["dp_loss"][step], r0["one_loss"][step], rtol=LOSS_RTOL)
    assert r1["dp_loss"][step] == r0["dp_loss"][step]
    nonzero = 0
    for name, want in r0["one_grads"][step].items():
        got = r0["dp_grads"][step][name]
        assert torch.equal(got, r1["dp_grads"][step][name]), name  # every rank clips the same gradient
        if float(torch.linalg.vector_norm(want)) > 0:
            nonzero += 1
            assert _rel_l2(got, want) <= GRAD_REL_L2, name
        else:
            assert float(torch.linalg.vector_norm(got)) == 0.0, name
    assert nonzero > 0.9 * len(r0["one_grads"][step])  # not vacuous


@pytest.mark.parametrize("key", ["params", "ema"])
def test_parameters_identical_across_ranks_after_the_steps(run, key):
    (r0, r1), _ = run
    for name, p in r0[f"dp_{key}"].items():
        assert torch.equal(p, r1[f"dp_{key}"][name]), name
    # the optimizer (learning rate 1e-3, no warm-up) moved them: the EMA lags
    assert any(not torch.equal(p, r0["dp_ema"][n]) for n, p in r0["dp_params"].items())


def test_dp_loss_matches_jax_sharded_loss(run):
    """train=False, injected timesteps and noise; JAX's batch sharded over
    the 8-device mesh as ``tests/test_multichip.py`` shards it."""
    (r0, r1), _ = run
    jm, params = _jax_params()
    batch = worker.dp_batch(8, 16, 55)
    mesh = make_mesh(MeshConfig())
    shard = batch_sharding(mesh)
    config = jtrain.TrainConfig()

    def loss_of(p, w, c, cd, ts, nz):
        loss, _ = jtrain.said_loss(jm, JSchedule.create(1000), p, jax.random.PRNGKey(0), w, c, cd, None, None,
                                   config, train=False, timesteps=ts, noise=nz)
        return loss

    args = [jax.device_put(jnp.asarray(batch[k]), shard) for k in ("waveform", "coeffs", "cond", "timesteps", "noise")]
    want = float(jax.jit(loss_of)(shard_params(params, mesh), *args))
    assert float(r0["eval_loss"]) == float(r1["eval_loss"])
    np.testing.assert_allclose(float(r0["eval_loss"]), want, rtol=1e-5)


def test_train_cli_mesh_data_2_matches_mesh_data_1(run, monkeypatch):
    (r0, r1), work = run
    monkeypatch.setattr(train_cli, "build_said_model", lambda prediction_type, feature_dim, dtype, remat: SAID(
        audio_config=Wav2Vec2Config(**worker.DP_AUDIO), prediction_type=prediction_type, remat=remat))
    train_cli.main(_cli_argv(work, work / "out1", 1))
    one = torch.load(work / "out1" / "2.pth", weights_only=True)
    two = torch.load(work / "out2" / "2.pth", weights_only=True)
    assert one.keys() == two.keys()
    for name, want in one.items():
        scale = float(torch.linalg.vector_norm(want))
        assert float(torch.linalg.vector_norm(two[name] - want)) <= GRAD_REL_L2 * max(scale, 1e-12), name
    # rank 0 alone wrote: the metrics (one line an epoch), the checkpoint and the .pth
    assert sorted(r0["cli_writes"]) == ["MetricsWriter", "save_pth", "save_train_state"]
    assert r1["cli_writes"] == []
    lines = (work / "out2" / "SAiD" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    assert "Validation/loss" in json.loads(lines[1])
