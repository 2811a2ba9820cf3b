"""Tensor-parallel training of the port on the CPU (gloo ranks on a 'model'
axis, and a data × model × seq mesh of 1 × 2 × 2) against one process and
against the JAX package's ``shard_params`` placement and loss.

Two launches of ``tests/torch_parallel_worker.py`` under ``python -m
torch.distributed.run`` (read by module-scoped fixtures), at
``tests/test_multichip.py``'s tiny config with weights from the JAX
``fast_init``: ``tensor`` on 2 ranks (model=2) and ``combined`` on 4
(``MeshConfig(data=1, model=2, seq=2)``, JAX's ``test_mesh_shapes``
layout). Bounds as ``tests/test_torch_seq_parallel_train.py``'s: a train
step against one process within 1e-6 relative (loss) and 1e-5 relative
L2 (each whole gradient), the deterministic loss and gradients against
JAX on the matching CPU mesh within 1e-5 and 1e-4, replicated parameters
and EMA bit-identical across the ranks after the step. Each rank's shard
is JAX's shard of the same tensor, where the port places it as JAX does.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from said_tpu.parallel import mesh as jmesh
from said_tpu.parallel.mesh import MeshConfig
from said_tpu_torch.convert import said_state_dict
from said_tpu_torch.models.said import SAID
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.parallel import mesh
from said_tpu_torch.parallel.tensor import join_state_dict, shard_state_dict, tensor_plan
from test_torch_seq_parallel import launch
from test_torch_seq_parallel_train import (
    assert_cli_matches_one_process,
    compare_steps,
    compare_with_jax,
    jax_loss_and_grads,
    jax_params,
    write_work,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in the test process (``tests/test_torch_train_loss.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    write_work(work, "--mesh_data", "1", "--mesh_model", "2")
    return launch(2, work, "tensor"), work


@pytest.fixture(scope="module")
def combined(tmp_path_factory):
    work = tmp_path_factory.mktemp("tpsp")
    write_work(work)
    return launch(4, work, "combined")


def _port_model():
    model = SAID(audio_config=Wav2Vec2Config(**worker.DP_AUDIO))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in said_state_dict(jax_params()).items()},
                          strict=True)
    return model


def test_tp_train_step_matches_one_process(run):
    (r0, r1), _ = run
    compare_steps(r0["tp"], r0["one"], r1["tp"])


@pytest.mark.parametrize("key", ["params", "ema"])
def test_tp_parameters_identical_across_ranks(run, key):
    """Replicated parameters (and their EMA) hold the same bits on both
    ranks, and so do the whole tensors gathered from the shards."""
    (r0, r1), _ = run
    plan = r0["plan"]
    local = r0["tp"][f"local_{key}"]
    assert any(n in plan for n in local) and any(n not in plan for n in local)
    for name, p in local.items():
        if name not in plan:
            assert torch.equal(p, r1["tp"][f"local_{key}"][name]), name
    for name, p in r0["tp"][key].items():
        assert torch.equal(p, r1["tp"][key][name]), name


def test_tp_loss_and_grads_match_jax_shard_params(run):
    (r0, r1), _ = run
    assert torch.equal(r0["deterministic"]["loss"], r1["deterministic"]["loss"])
    want_loss, want_grads = jax_loss_and_grads(worker.train_batch(73, injected=True),
                                               MeshConfig(data=1, model=2, seq=1), "dense")
    compare_with_jax(r0["deterministic"], want_loss, want_grads)


def test_tp_eval_step_matches_one_process(run):
    """The validation step: the GEGLU kernel's route at the shard's width
    (I = 384 a rank), the bias added after the sum over the ranks."""
    (r0, r1), _ = run
    assert r0["eval"]["tp"] == r1["eval"]["tp"]
    for k, want in r0["eval"]["one"].items():
        np.testing.assert_allclose(r0["eval"]["tp"][k], want, rtol=1e-6, err_msg=k)


def test_tp_checkpoint_round_trip(run):
    """``TrainState.state_dict`` gathers whole tensors (the unsharded
    model's shapes) and ``load_state_dict`` of them gives each rank its
    shards, moments and EMA back, bit for bit."""
    (r0, r1), _ = run
    want = {k: tuple(v.shape) for k, v in _port_model().state_dict().items()}
    for r in (r0, r1):
        assert r["resume"]["whole_shapes"] == want
        assert r["resume"]["identical"]


def _jax_shards(m):
    """Each model rank's shard of every parameter under JAX's
    ``shard_params`` on a (1, m, 1) mesh, by torch name (torch layout)."""
    params = jax_params()
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=1, model=m, seq=1), jax.devices()[:m])
    placed = jmesh.shard_params(params, jm)
    out = []
    for device in jm.devices[0, :, 0]:
        tree = jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)),
                            placed)
        out.append(said_state_dict(tree))
    return out


@pytest.mark.parametrize("m", [2, 4])
def test_shards_match_jax_shard_params(run, m):
    """Where JAX splits a tensor the port holds JAX's block, except GEGLU's
    up projection, whose block is (a_r | g_r), and attention layers whose
    heads the axis does not divide (replicated; at m = 4 the UNet's 6 heads
    and the encoder's 2), where JAX splits heads apart. A column-parallel
    bias splits with its weight (JAX replicates biases). At m = 2 the
    ranks' own shards are these."""
    (r0, r1), _ = run
    model = _port_model()
    whole = model.state_dict()
    plan = tensor_plan(model, m)
    jax_shards = _jax_shards(m)
    if m == 2:
        assert set(r0["plan"]) == set(plan)
    for r in range(m):
        mine = shard_state_dict(whole, plan, r, m)
        if m == 2:
            for name, t in (r0, r1)[r]["shards"].items():
                assert torch.equal(t, mine[name]), name
        for name, w in whole.items():
            theirs = torch.from_numpy(np.array(jax_shards[r][name]))
            if name.endswith("ff.net.0.proj.weight"):
                a, g = w.chunk(2, 0)
                n = a.shape[0] // m
                assert torch.equal(mine[name], torch.cat([a[r * n:(r + 1) * n], g[r * n:(r + 1) * n]]))
                assert torch.equal(theirs, w.chunk(m, 0)[r])
            elif theirs.shape != w.shape:  # JAX splits it
                if name in plan:
                    assert torch.equal(mine[name], theirs), name
                else:
                    owner = model.get_submodule(name.rsplit(".", 3 if ".to_out." in name else 2)[0])
                    assert owner.heads % m, name
            else:
                assert name not in plan or name.endswith(".bias"), name


@pytest.mark.parametrize("m", [2, 3, 4])
def test_shard_and_join_state_dict_round_trip(m):
    model = _port_model()
    whole = model.state_dict()
    plan = tensor_plan(model, m)
    assert plan  # the feed-forwards split at every m here
    joined = join_state_dict([shard_state_dict(whole, plan, r, m) for r in range(m)], plan)
    assert joined.keys() == whole.keys()
    for name, t in whole.items():
        assert torch.equal(joined[name], t), name


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1), (1, 2, 4), (2, 1, 4)], ids=lambda s: "x".join(map(str, s)))
def test_data_seq_groups_follow_the_jax_device_grid(shape):
    """The ranks that share a model coordinate (the gradient sum's group)
    are the devices of one model index on the JAX mesh, data-major."""
    cfg = mesh.MeshConfig(*shape).resolve(8)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(lambda d: ids[d.id])(jmesh.make_mesh(jmesh.MeshConfig(*shape)).devices)
    assert mesh.axis_ranks(cfg, "data_seq") == [grid[:, m].reshape(-1).tolist() for m in range(cfg.model)]


def test_sliced_generator_cuts_compose():
    """Rows then frames then columns: the global draw, narrowed on each."""
    g = torch.Generator().manual_seed(5)
    sliced = mesh.SlicedGenerator(mesh.SlicedGenerator(mesh.sliced(g, 0, slice(2, 4), 4), 1, slice(3, 6), 9),
                                  2, slice(0, 2), 6)
    want = torch.randn((4, 9, 6), generator=torch.Generator().manual_seed(5))[2:4, 3:6, 0:2]
    assert torch.equal(mesh.randn((2, 3, 2), sliced, "cpu"), want)
    assert mesh.sliced(g, 1, slice(0, 9), 9) is g and mesh.sliced(None, 0, slice(0, 1), 2) is None


def test_train_cli_mesh_model_2_matches_mesh_data_1(run, monkeypatch):
    """``--mesh_model 2`` under torchrun against one process: the epoch-2
    ``.pth`` and train state whole, the ``.pth`` within 1e-5 relative L2 a
    tensor; rank 0 alone wrote."""
    (r0, r1), work = run
    assert sorted(r0["cli_writes"]) == ["MetricsWriter", "save_pth", "save_train_state"]
    assert r1["cli_writes"] == []
    assert_cli_matches_one_process(work, monkeypatch)
    lines = (work / "out_mesh" / "SAiD" / "metrics.jsonl").read_text().splitlines()
    assert np.isfinite(json.loads(lines[0])["Train/loss"])


@pytest.mark.parametrize("variant", ["mesh", "remat"])
def test_combined_mesh_matches_one_process(combined, variant):
    """A 1 × 2 × 2 mesh (model and seq axes together), and again with
    gradient checkpointing (the collectives re-issued in the backward),
    against one process; every rank holds the same losses and whole
    gradients."""
    ranks = combined
    for r in ranks[1:]:
        compare_steps(ranks[0][variant], ranks[0]["one"], r[variant])


def test_combined_parameters_identical_across_replicas(combined):
    """After the step, ranks of one model index hold the same bits (the
    seq axis's replicas), and the replicated parameters are the same on
    all four."""
    ranks = combined
    plan_names = {n for n, p in ranks[0]["mesh"]["params"].items()
                  if p.shape != ranks[0]["mesh"]["local_params"][n].shape}
    assert plan_names
    for r in ranks:
        peer = next(q for q in ranks if q["coords"][0] == r["coords"][0] and q is not r)
        for key in ("local_params", "local_ema"):
            for name, p in r["mesh"][key].items():
                assert torch.equal(p, peer["mesh"][key][name]), name
                if name not in plan_names:
                    assert torch.equal(p, ranks[0]["mesh"][key][name]), name


def test_combined_loss_and_grads_match_jax_1x2x2(combined):
    ranks = combined
    for r in ranks[1:]:
        assert torch.equal(r["deterministic"]["loss"], ranks[0]["deterministic"]["loss"])
    want_loss, want_grads = jax_loss_and_grads(worker.train_batch(77, injected=True),
                                               MeshConfig(data=1, model=2, seq=2), "flash_sp")
    compare_with_jax(ranks[0]["deterministic"], want_loss, want_grads)
