"""Sequence-parallel training of the port on the CPU: 2 gloo ranks (a 'seq'
axis of 2) against one process and against the JAX package's loss on a
``MeshConfig(data=1, model=1, seq=2)`` CPU mesh.

The ranks are one ``python -m torch.distributed.run --nproc_per_node 2``
launch of ``tests/torch_parallel_worker.py seqtrain`` (its results read by
a module-scoped fixture), at ``tests/test_multichip.py``'s tiny config with
weights from the JAX ``fast_init``. Each window is 24 frames, 12 a rank,
21 of them real, so the real length ends inside rank 1:

- one train-mode step (dropout, layerdrop, spec-augment, drawn timesteps
  and noise; std reweighting and blendshape deltas) on 2 ranks against one
  process: the loss within 1e-6 relative, each gradient the optimizer
  receives within 1e-5 relative L2 (``tests/test_torch_data_parallel.py``'s
  bounds), and all parameters and all EMA after the step within 1e-5
  relative L2 together (a single tensor near zero moves more: the first
  AdamW update is about lr · sign(g)), parameters and EMA identical on
  both ranks after the step; the same with ``DENSE_MAX``,
  ``BWD_DENSE_MAX`` and ``BWD_BLOCK_K`` patched small in both, so the
  gathered keys take the flash route and the blockwise backward;
- the deterministic loss and gradients (injected timesteps and noise)
  against JAX's ``said_loss`` and ``jax.value_and_grad`` on the seq mesh,
  within ``tests/test_torch_train_loss.py``'s 1e-5 relative and 1e-4
  relative L2;
- the collectives' gradients: ``flash_attention_flat_sp`` against dense
  attention, the masked frame-sharded GroupNorm against the unsharded one
  (a rank with no real frame too), ``halo`` and ``gather`` against the
  unsharded arithmetic, each within 1e-5 relative L2 (2e-5 for the
  attention, whose local call is the plain flash version);
- the train CLI with ``--mesh_seq 2`` against ``--mesh_data 1``, 2 epochs:
  the ``.pth`` within 1e-5 relative L2 a tensor, and only rank 0 wrote.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_worker as worker
from said_tpu.cli._common import fast_init
from said_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu.parallel.mesh import MeshConfig, make_mesh
from said_tpu.train import said_train as jtrain
from said_tpu_torch.cli import train as train_cli
from said_tpu_torch.convert import said_state_dict, unet1d_state_dict
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.unet1d import band_tables
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.ops.attention import dense_attention
from said_tpu_torch.ops.norms import group_norm_masked_plain
from said_tpu_torch.parallel.mesh import AxisGroup
from test_torch_data_parallel import _write_tree

LOSS_RTOL, GRAD_REL_L2 = 1e-6, 1e-5
JAX_LOSS_RTOL, JAX_GRAD_REL_L2 = 1e-5, 1e-4


def _cli_argv(root, out, *mesh):
    return ["--device", "cpu", "--audio_dir", str(root / "audio"), "--coeffs_dir", str(root / "coeffs"),
            "--output_dir", str(out), "--batch_size", "2", "--num_warmup_epochs", "1", "--val_repeat", "1",
            "--epochs", "2", "--val_period", "2", "--save_period", "2", *mesh]


def jax_params():
    jm = JSAID(audio_config=JCfg(**worker.DP_AUDIO))
    return jax.tree.map(np.asarray, fast_init(jm, 0))


def write_work(work, *mesh):
    """The weights, a tiny tree and the CLI's flags the worker reads."""
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in said_state_dict(jax_params()).items()},
               work / "said.pth")
    _write_tree(work)
    (work / "cli_argv.json").write_text(json.dumps(_cli_argv(work, work / "out_mesh", *mesh)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread is as fast, and under a parallel
    test run (several workers on the machine's cores) far faster than
    threads that wait on each other (``tests/test_torch_train_loss.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from test_torch_seq_parallel import launch

    work = tmp_path_factory.mktemp("sptrain")
    write_work(work, "--mesh_data", "1", "--mesh_seq", "2")
    return launch(2, work, "seqtrain"), work


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def compare_steps(got, want, r1_got, loss_rtol=LOSS_RTOL, grad_rel=GRAD_REL_L2):
    """Losses and gradients of a sharded run against one process's; every
    gradient the same on both ranks."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    assert torch.equal(got["loss"], r1_got["loss"])
    nonzero = 0
    for step, grads in enumerate(want["grads"]):
        for name, w in grads.items():
            g = got["grads"][step][name]
            assert torch.equal(g, r1_got["grads"][step][name]), name
            if float(torch.linalg.vector_norm(w)) > 0:
                nonzero += 1
                assert rel_l2(g, w) <= grad_rel, (name, rel_l2(g, w))
            else:
                assert float(torch.linalg.vector_norm(g)) == 0.0, name
    assert nonzero > 0.9 * sum(len(g) for g in want["grads"])  # not vacuous
    # after the clip and the update: every parameter and EMA tensor, whole
    # and concatenated, within the gradients' bound (a wrong clip norm moves
    # the update by its own scale, ~1e-2 of the parameters at lr 1e-3)
    for key in ("params", "ema"):
        got_all = torch.cat([got[key][n].reshape(-1) for n in want[key]])
        want_all = torch.cat([w.reshape(-1) for w in want[key].values()])
        assert rel_l2(got_all, want_all) <= grad_rel, (key, rel_l2(got_all, want_all))


def compare_with_jax(got, want_loss, want_grads):
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=JAX_LOSS_RTOL)
    assert set(got["grads"]) == set(want_grads)
    nonzero = 0
    for name, want in want_grads.items():
        g = got["grads"][name].numpy()
        assert g.shape == want.shape, name
        if np.linalg.norm(want) > 0:
            nonzero += 1
            assert rel_l2(g, want) <= JAX_GRAD_REL_L2, (name, rel_l2(g, want))
    assert nonzero > 0.9 * len(want_grads)


def jax_loss_and_grads(batch, mesh_config, self_attn_impl):
    """The deterministic ``said_loss`` and its trainable gradients, jitted on
    a CPU mesh with the coefficients and noise frame-sharded over 'seq' and
    the parameters placed by ``shard_params``; torch names."""
    from said_tpu.parallel.mesh import shard_params

    jm = JSAID(audio_config=JCfg(**worker.DP_AUDIO), self_attn_impl=self_attn_impl)
    params = jax_params()
    mesh = make_mesh(mesh_config, jax.devices()[:mesh_config.data * mesh_config.model * mesh_config.seq])
    frames = NamedSharding(mesh, P(None, "seq", None))

    def f(trainable, coeffs, noise):
        return jtrain.said_loss(jm, JSchedule.create(1000), jtrain.merge_trainable(placed, trainable),
                                jax.random.PRNGKey(0), jnp.asarray(batch["waveform"]), coeffs,
                                jnp.asarray(batch["cond"]), jnp.asarray(batch["std"]),
                                jnp.asarray(batch["blendshape_delta"]), jtrain.TrainConfig(), train=False,
                                mask_time_indices=jnp.asarray(batch["mask_time_indices"]),
                                window_real=jnp.asarray(batch["window_real"], jnp.int32),
                                input_length=jnp.asarray(batch["input_length"], jnp.int32),
                                timesteps=jnp.asarray(batch["timesteps"]), noise=noise)

    placed = shard_params(params, mesh)
    coeffs = jax.device_put(jnp.asarray(batch["coeffs"]), frames)
    noise = jax.device_put(jnp.asarray(batch["noise"]), frames)
    (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jtrain.trainable_subset(placed), coeffs, noise)
    named = unet1d_state_dict(jax.tree.map(np.asarray, grads["denoiser"]))
    named["null_cond_emb"] = np.asarray(grads["null_cond_emb"])
    return float(loss), named


@pytest.mark.parametrize("routes", ["dense", "flash_blockwise"])
def test_sp_train_step_matches_one_process(run, routes):
    (r0, r1), _ = run
    sp, one = ("sp", "one") if routes == "dense" else ("sp_small_routes", "one_small_routes")
    compare_steps(r0[sp], r0[one], r1[sp])


@pytest.mark.parametrize("key", ["local_params", "local_ema"])
def test_sp_parameters_identical_across_ranks(run, key):
    (r0, r1), _ = run
    for name, p in r0["sp"][key].items():
        assert torch.equal(p, r1["sp"][key][name]), name
    # the optimizer (learning rate 1e-3, no warm-up) moved them: the EMA lags
    assert any(not torch.equal(p, r0["sp"]["local_ema"][n]) for n, p in r0["sp"]["local_params"].items())


def test_sp_loss_and_grads_match_jax_seq_mesh(run):
    (r0, r1), _ = run
    assert torch.equal(r0["deterministic"]["loss"], r1["deterministic"]["loss"])
    want_loss, want_grads = jax_loss_and_grads(worker.train_batch(71, injected=True),
                                               MeshConfig(data=1, model=1, seq=2), "flash_sp")
    compare_with_jax(r0["deterministic"], want_loss, want_grads)


def _grads_close(got, want, bound):
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= bound, rel_l2(g, w)


def _reference_grads(fn, xs, seed):
    xs = [torch.from_numpy(x).requires_grad_() for x in xs]
    y = fn(*xs)
    w = torch.from_numpy(worker.rand(y.shape, seed))
    return y.detach(), torch.autograd.grad((y * w).sum(), xs)


def test_flash_attention_flat_sp_gradient_matches_dense(run):
    """Two ranks' queries against the gathered keys: the output and the
    gradients of q, k and v (dk and dv summed over the ranks by the
    gathers' backward) against dense attention's."""
    (r0, r1), _ = run
    y, grads = r0["flat_sp_grad"]
    assert torch.equal(y, r1["flat_sp_grad"][0])
    want_y, want = _reference_grads(lambda q, k, v: dense_attention(q, k, v, worker.ATTN["heads"]),
                                    worker.attention_inputs(), 60)
    np.testing.assert_allclose(y, want_y, atol=2e-5, rtol=1e-4)
    _grads_close(grads, want, 2e-5)


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("real", [500, 250], ids=["real_in_rank_1", "rank_1_all_padding"])
def test_group_norm_sharded_masked_gradient(run, real, act):
    """The masked frame-sharded GroupNorm (each rank's statistics over its
    real frames, joined) and its backward against the unsharded masked
    GroupNorm's autograd: dx gathered, dweight and dbias summed."""
    (r0, r1), _ = run
    y, dx, dw, db = r0[f"group_norm_{real}_{act}"]
    x, w, b = (torch.from_numpy(a) for a in worker.group_norm_inputs())
    xs, ws, bs = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    want_y = group_norm_masked_plain(xs, 32, ws, bs, torch.full((2,), real, dtype=torch.int32), 1e-6, act)
    want = torch.autograd.grad((want_y * torch.from_numpy(worker.rand(x.shape, 61))).sum(), [xs, ws, bs])
    np.testing.assert_allclose(y, want_y.detach(), atol=4e-5, rtol=1e-5)
    dw_sum = dw + r1[f"group_norm_{real}_{act}"][2]
    db_sum = db + r1[f"group_norm_{real}_{act}"][3]
    _grads_close([dx, dw_sum, db_sum], want, GRAD_REL_L2)


@pytest.mark.parametrize("case", ["halo", "gather"])
def test_halo_and_gather_gradients(run, case):
    """``halo`` (3 frames each side of a 2-frame block: frames of both ranks
    and the clip's zeros) and ``gather`` (each rank weights the gathered
    clip by its index + 1): the gradients every rank's output sends back,
    against the unsharded arithmetic."""
    (r0, r1), _ = run
    x = worker.rand((2, 4, 3), 62)
    if case == "halo":
        def fn(a):  # each rank's halo, stacked
            padded = torch.nn.functional.pad(a, (0, 0, 3, 3))
            return torch.cat([padded[:, r * 2:r * 2 + 8] for r in range(2)], dim=1)
        seed = 63
    else:
        def fn(a):
            return torch.cat([a * (r + 1.0) for r in range(2)], dim=1)
        seed = 64
    # the worker gathered each rank's output along frames; its weights are
    # the gathered output's shape drawn once, cut to the ranks' frames
    y0, (g0,) = r0[case]
    y1, (g1,) = r1[case]
    assert torch.equal(g0, g1)
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    w = torch.from_numpy(worker.rand(y.shape, seed))
    (want,) = torch.autograd.grad((y * w).sum(), [xt])
    np.testing.assert_allclose(y0, y.detach(), atol=0, rtol=0)
    assert rel_l2(g0, want) <= 1e-6


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("real", [48, 37, 13], ids=["unpadded", "real_in_last_block", "real_in_first_block"])
def test_band_tables_with_lengths_and_seq_group(n, real):
    """The dynamic alignment band of a bucketed window, cut to each rank's
    rows, is the unsharded band's rows (both ``real`` and ``seq_group``)."""
    idx, valid = band_tables(48, 48, torch.device("cpu"), real=real)
    for r in range(n):
        got_idx, got_valid = band_tables(48 // n, 48, torch.device("cpu"), real=real, seq_group=AxisGroup(None, r, n))
        rows = slice(r * 48 // n, (r + 1) * 48 // n)
        assert torch.equal(got_idx, idx[rows]) and torch.equal(got_valid, valid[rows])


def test_train_cli_mesh_seq_2_matches_mesh_data_1(run, monkeypatch):
    """``--mesh_seq 2`` under torchrun against one process: the epoch-2
    ``.pth`` within 1e-5 relative L2 a tensor; rank 0 alone wrote."""
    (r0, r1), work = run
    assert sorted(r0["cli_writes"]) == ["MetricsWriter", "save_pth", "save_train_state"]
    assert r1["cli_writes"] == []
    assert_cli_matches_one_process(work, monkeypatch)


def assert_cli_matches_one_process(work, monkeypatch):
    monkeypatch.setattr(train_cli, "build_said_model", lambda prediction_type, feature_dim, dtype, remat: SAID(
        audio_config=Wav2Vec2Config(**worker.DP_AUDIO), prediction_type=prediction_type, remat=remat))
    train_cli.main(_cli_argv(work, work / "out_one", "--mesh_data", "1"))
    one = torch.load(work / "out_one" / "2.pth", weights_only=True)
    got = torch.load(work / "out_mesh" / "2.pth", weights_only=True)
    assert one.keys() == got.keys()
    for name, want in one.items():
        assert got[name].shape == want.shape, name
        scale = float(torch.linalg.vector_norm(want))
        assert float(torch.linalg.vector_norm(got[name] - want)) <= GRAD_REL_L2 * max(scale, 1e-12), name
    lines = (work / "out_mesh" / "SAiD" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    assert "Validation/loss" in json.loads(lines[1])
    state = torch.load(work / "out_mesh" / "ckpt" / "2" / "train_state.pt", weights_only=True)
    want_state = torch.load(work / "out_one" / "ckpt" / "2" / "train_state.pt", weights_only=True)
    assert state["step"] == want_state["step"] and state["optimizer"]["count"] == want_state["optimizer"]["count"]
    for name, p in want_state["model"].items():
        assert state["model"][name].shape == p.shape, name
