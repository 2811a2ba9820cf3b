"""The port's training pieces against the JAX package, on the CPU.

- Each kernel router's backward (the PyTorch functions behind its
  ``torch.autograd.Function``) against ``jax.vjp`` of its JAX router:
  GroupNorm plain, masked and with SiLU, LayerNorm, GEGLU, the strided
  conv, and attention with the dense-recompute and the blockwise
  backward. Bound: 1e-5 of max |JAX| (f32; the closed forms and autodiff
  differ in summation order only); the bf16 blockwise backward within
  2e-2 of max |JAX| (both round the same operands to bf16).
- The optimizer (clip, warm-up schedule, AdamW) and the EMA against optax
  and ``ema_update`` on identical numpy gradients, a skipped step
  included: 1e-6 relative.
- ``compute_time_mask_indices`` and the train and validation collates
  bit-identical to the JAX package's on the same seed.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import said_tpu.ops.pallas_attention as pa
from said_tpu.data import blendvoca as jblendvoca
from said_tpu.data.loader import DataLoader as JDataLoader
from said_tpu.models.wav2vec2 import compute_time_mask_indices as j_time_mask
from said_tpu.ops.norms import group_norm as j_group_norm
from said_tpu.ops.norms import group_norm_masked as j_group_norm_masked
from said_tpu.ops.norms import layer_norm_f32 as j_layer_norm
from said_tpu.ops.pallas_conv import strided_conv_gelu as j_conv
from said_tpu.ops.pallas_ffn import geglu_ffn as j_geglu
from said_tpu.train import said_train as jtrain
from said_tpu.train.ema import ema_update as j_ema_update
from said_tpu.utils.audio import save_audio
from said_tpu.utils.blendshape import save_blendshape_coeffs
from said_tpu_torch.data import blendvoca
from said_tpu_torch.data.loader import DataLoader
from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices
from said_tpu_torch.ops import attention, conv, ffn, norms
from said_tpu_torch.train import said_train
from said_tpu_torch.train.ema import ema_update_

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread is as fast, and under a parallel
    test run (several workers on the machine's cores) far faster than
    threads that wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def _vjp_port(fn, inputs, g):
    """The port router's value and input gradients, by its autograd."""
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    assert out.grad_fn is not None  # no gradient is silently lost
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


def _vjp_jax(fn, inputs, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_group_norm_backward_matches_jax_vjp(act, masked):
    x, w, b = _rand((2, 37, 64), 0, 2.0, 3.0), _rand((64,), 1), _rand((64,), 2)
    g = _rand((2, 37, 64), 3)
    lens = np.array([37, 21], np.int32)
    if masked:
        def port(x_, w_, b_):
            return norms.group_norm_masked(x_, 8, w_, b_, torch.from_numpy(lens), 1e-5, act)

        def jx(x_, w_, b_):
            return j_group_norm_masked(x_, 8, w_, b_, jnp.arange(37)[None] < lens[:, None], 1e-5, act)
    else:
        def port(x_, w_, b_):
            return norms.group_norm(x_, 8, w_, b_, 1e-5, act)

        def jx(x_, w_, b_):
            return j_group_norm(x_, 8, w_, b_, 1e-5, act)

    got, want = _vjp_port(port, [x, w, b], g), _vjp_jax(jx, [x, w, b], g)
    _close([got[0]], [want[0]])
    _close(got[1], want[1])


def test_layer_norm_backward_matches_jax_vjp():
    x, w, b = _rand((2, 37, 96), 4, 2.0, 0.5), _rand((96,), 5), _rand((96,), 6)
    g = _rand((2, 37, 96), 7)
    got = _vjp_port(lambda *a: norms.layer_norm(*a, 1e-5), [x, w, b], g)
    want = _vjp_jax(lambda *a: j_layer_norm(*a, 1e-5), [x, w, b], g)
    _close([got[0]], [want[0]])
    _close(got[1], want[1])


def test_geglu_backward_matches_jax_vjp():
    x = _rand((2, 21, 192), 8)
    w1, b1 = _rand((192, 1536), 9, 0.05), _rand((1536,), 10, 0.1)  # flax (in, out)
    w2, b2 = _rand((768, 192), 11, 0.05), _rand((192,), 12, 0.1)
    g = _rand((2, 21, 192), 13)
    got = _vjp_port(lambda x_, a, c, d, e: ffn.geglu_ffn(x_, a.t(), c, d.t(), e), [x, w1, b1, w2, b2], g)
    _close(*[[o] for o in (got[0], _vjp_jax(j_geglu, [x, w1, b1, w2, b2], g)[0])])
    _close(got[1], _vjp_jax(j_geglu, [x, w1, b1, w2, b2], g)[1])


@pytest.mark.parametrize("k", [2, 3])
def test_strided_conv_backward_matches_jax_vjp(k):
    x, w = _rand((2, 41, 16), 14), _rand((k, 16, 24), 15, 0.2)
    t_out = (41 - k) // 2 + 1
    g = _rand((2, t_out, 24), 16)
    got, want = _vjp_port(conv.strided_conv_gelu, [x, w], g), _vjp_jax(j_conv, [x, w], g)
    _close([got[0]], [want[0]])
    _close(got[1], want[1])


@pytest.mark.parametrize("lengths", [None, [80, 50]], ids=["full", "lengths"])
@pytest.mark.parametrize("blockwise", [False, True], ids=["dense_recompute", "blockwise"])
def test_attention_backward_matches_jax_vjp(monkeypatch, blockwise, lengths):
    """Past the dense limit (patched to 0 here) self-attention is the flash
    route with its own backward; the backward's dense/blockwise threshold
    is patched on both sides (4096 keys in the shipped code)."""
    monkeypatch.setattr(attention, "DENSE_MAX", 0)
    if blockwise:
        monkeypatch.setattr(attention, "BWD_DENSE_MAX", 32)
        monkeypatch.setattr(attention, "BWD_BLOCK_K", 16)
        monkeypatch.setattr(pa, "_BWD_DENSE_MAX", 32)
        monkeypatch.setattr(pa, "_BWD_BLOCK_K", 16)
    q, k, v = (_rand((2, 80, 192), 20 + i) for i in range(3))
    g = _rand((2, 80, 192), 23)
    lens = None if lengths is None else np.array(lengths, np.int32)
    if lens is not None:
        # the flash forward gives 0 at query rows past a length, the dense
        # one does not, and both backwards follow the dense form there: a
        # padded row's gradient is 0 wherever the model pads (its loss and
        # pad zeroing see only real frames), so it is 0 here too
        g = g * (np.arange(80)[None, :, None] < lens[:, None, None])
    got = _vjp_port(lambda *a: attention.self_attention(*a, 6, None if lens is None else torch.from_numpy(lens)),
                    [q, k, v], g)
    want = _vjp_jax(lambda *a: pa.flash_attention_flat(*a, 6, None if lens is None else jnp.asarray(lens)),
                    [q, k, v], g)
    real = np.arange(80)[None, :, None] < (80 if lens is None else lens[:, None, None])
    _close([got[0] * real], [want[0] * real])
    _close(got[1], want[1])


def test_attention_backward_stays_blockwise_past_4096_keys(monkeypatch):
    """The shipped threshold: up to 4096 keys one block of every key (the
    dense recompute), 4097 in 1024-key blocks (no (T, S) tensor); both
    equal the dense autograd (tiny queries)."""
    assert attention.BWD_DENSE_MAX == 4096 and attention.BWD_BLOCK_K == 1024
    blocks = []
    blockwise = attention.chunked_attention_backward
    monkeypatch.setattr(attention, "chunked_attention_backward",
                        lambda *a, block_k=None, **kw: blocks.append(block_k) or blockwise(*a, block_k=block_k, **kw))
    q, g = torch.from_numpy(_rand((1, 3, 64), 30)), torch.from_numpy(_rand((1, 3, 64), 31))
    for s, block in ((4096, 4096), (4097, 1024)):
        blocks.clear()
        k, v = (torch.from_numpy(_rand((1, s, 64), seed)).requires_grad_() for seed in (32, 33))
        qq = q.clone().requires_grad_()
        out = attention.dense_attention(qq, k, v, 2)
        want = torch.autograd.grad(out, (qq, k, v), g)
        got = attention.attention_backward(q, k.detach(), v.detach(), out.detach(), g, 2)
        assert blocks == [block]
        _close([a.numpy() for a in got], [b.numpy() for b in want])


def test_blockwise_backward_bf16_matches_jax():
    """bf16 operands, f32 accumulation and statistics, on both sides."""
    q, k, v, g = (_rand((1, 70, 192), 40 + i) for i in range(4))
    o = np.array(pa._dense_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 6))
    want = pa._chunked_attn_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, o, g)), 6, block_k=32)
    got = attention.chunked_attention_backward(*(torch.from_numpy(a).bfloat16() for a in (q, k, v, o, g)), 6,
                                               block_k=32)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close([a.float().numpy()], [np.asarray(b, np.float32)], tol=2e-2)


def test_routers_record_no_graph_without_grad():
    x, w, b = (torch.from_numpy(a).requires_grad_() for a in (_rand((1, 8, 64), 50), _rand((64,), 51),
                                                               _rand((64,), 52)))
    with torch.no_grad():
        assert norms.layer_norm(x, w, b).grad_fn is None
        assert norms.group_norm(x, 8, w, b).grad_fn is None
    assert norms.group_norm(x.detach(), 8, w.detach(), b.detach()).grad_fn is None


# ------------------------------------------------------- optimizer, EMA


def test_optimizer_and_ema_match_optax_with_a_skipped_step():
    """Five steps of clip → AdamW (warm-up 3, so step 0 has lr 0) → EMA,
    the third skipped by the NaN guard: params, moments, counts and EMA
    against optax's chain and ``ema_update`` on the same gradients."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scales = [3.0, 0.05, 1.0, 2.0, 0.01]  # global norms above and below the clip
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()} for sc in scales]
    skip = {2}
    cfg_j = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=3)
    cfg_p = said_train.TrainConfig(learning_rate=1e-2, warmup_steps=3)

    tx = jtrain.make_optimizer(cfg_j)
    j_params = {"denoiser": {k: jnp.asarray(v) for k, v in params.items()}}
    j_state, j_ema = tx.init(j_params), j_params
    p_params = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = said_train.Optimizer(p_params, cfg_p)
    p_ema = [p.clone() for p in p_params]
    for step, g in enumerate(grads):
        if step in skip:
            continue  # the guard: nothing moves but the step count
        updates, j_state = tx.update({"denoiser": {k: jnp.asarray(v) for k, v in g.items()}}, j_state, j_params)
        import optax

        j_params = optax.apply_updates(j_params, updates)
        j_ema = j_ema_update(j_ema, j_params, cfg_j.ema_decay, jnp.asarray(step))
        opt.update([torch.from_numpy(g[k]) for k in shapes])
        ema_update_(p_ema, p_params, cfg_p.ema_decay, step)
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(p_params[i].numpy(), np.asarray(j_params["denoiser"][k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(p_ema[i].numpy(), np.asarray(j_ema["denoiser"][k]), rtol=1e-6, atol=1e-7)
    adam = j_state.inner_state[1][0]
    assert opt.count == int(adam.count) == len(grads) - len(skip)
    for i, k in enumerate(shapes):  # moments: 1e-6 of the tensor's largest (cancellation near 0)
        for got, want in ((opt.mu[i], adam.mu["denoiser"][k]), (opt.nu[i], adam.nu["denoiser"][k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_warmup_schedule_matches_optax():
    import optax

    lr, warmup = 1e-5, 7
    sched = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup), optax.constant_schedule(lr)], [warmup])
    opt = said_train.Optimizer([], said_train.TrainConfig(learning_rate=lr, warmup_steps=warmup))
    for count in range(12):
        assert opt.learning_rate(count) == float(np.float32(sched(count))), count
    assert opt.learning_rate(0) == 0.0


def test_train_step_nan_guard():
    """A non-finite loss skips the update: parameters, optimizer state and
    EMA stay bit for bit, the step count still moves."""
    from said_tpu_torch.cli._common import random_init_
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    pm = random_init_(SAID(audio_config=Wav2Vec2Config.tiny()), seed=0)
    state = said_train.TrainState(pm, said_train.TrainConfig())
    schedule = DiffusionSchedule.create(1000)
    batch = {"waveform": torch.from_numpy(_rand((2, 3200), 60)), "coeffs": torch.from_numpy(_rand((2, 12, 32), 61)),
             "cond": torch.tensor([True, False]), "std": None, "blendshape_delta": None}
    g = torch.Generator().manual_seed(0)
    said_train.train_step(state, schedule, batch, g)
    before = ({n: p.detach().clone() for n, p in state.params.items()}, [m.clone() for m in state.optimizer.mu],
              {n: e.clone() for n, e in state.ema.items()}, state.optimizer.count)
    bad = dict(batch, coeffs=batch["coeffs"].clone())
    bad["coeffs"][0, 0, 0] = float("nan")
    metrics = said_train.train_step(state, schedule, bad, g)
    assert metrics["nan_skipped"] == 1.0 and state.step == 2 and state.optimizer.count == before[3] == 1
    assert all(torch.equal(p, before[0][n]) for n, p in state.params.items())
    assert all(torch.equal(m, b) for m, b in zip(state.optimizer.mu, before[1]))
    assert all(torch.equal(e, before[2][n]) for n, e in state.ema.items())
    metrics = said_train.train_step(state, schedule, batch, g)
    assert metrics["nan_skipped"] == 0.0 and state.optimizer.count == 2 and state.step == 3


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape,kw", [((4, 130), {}), ((3, 37), dict(mask_prob=0.5, mask_length=4)),
                                      ((3, 60), dict(input_lengths=np.array([60, 25, 10]))), ((2, 8), {})])
def test_time_mask_indices_match_jax(shape, kw, seed):
    got = compute_time_mask_indices(shape, rng=np.random.default_rng(seed), **kw)
    want = j_time_mask(shape, rng=np.random.default_rng(seed), **kw)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """Two train persons (two sentences, one with a second take), one val
    person; 2.1–2.5-s clips; per-person deltas and landmarks."""
    root = tmp_path_factory.mktemp("blendvoca")
    rng = np.random.default_rng(0)
    persons = jblendvoca.PERSON_IDS_TRAIN[:2] + jblendvoca.PERSON_IDS_VAL[:1]
    for pid in persons:
        (root / "audio" / pid).mkdir(parents=True)
        (root / "coeffs" / pid).mkdir(parents=True)
        for sid in (1, 2):
            n = int(rng.integers(126, 150))
            save_audio(str(root / "audio" / pid / f"sentence{sid:02}.wav"),
                       (0.1 * rng.standard_normal(n * 16000 // 60)).astype(np.float32), 16000)
            for take in ([""] if sid == 1 else ["", "-1"]):
                save_blendshape_coeffs(rng.uniform(0, 1, (n, 32)).astype(np.float32), jblendvoca.BLENDSHAPE_CLASSES,
                                       str(root / "coeffs" / pid / f"sentence{sid:02}{take}.csv"))
    deltas = {pid: {c: rng.standard_normal((30, 3)).astype(np.float32) for c in jblendvoca.BLENDSHAPE_CLASSES}
              for pid in persons}
    with open(root / "deltas.pkl", "wb") as f:
        pickle.dump(deltas, f)
    (root / "landmarks.txt").write_text("\n".join(str(i) for i in (0, 3, 7, 29)))
    return {k: str(root / v) for k, v in (("audio_dir", "audio"), ("blendshape_coeffs_dir", "coeffs"),
                                          ("blendshape_deltas_path", "deltas.pkl"),
                                          ("landmarks_path", "landmarks.txt"))}


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a.waveform) == len(b.waveform)
        for x, y in zip(a.waveform, b.waveform):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.blendshape_coeffs, b.blendshape_coeffs)
        np.testing.assert_array_equal(a.cond, b.cond)
        np.testing.assert_array_equal(a.blendshape_delta, b.blendshape_delta)


def test_train_collate_matches_jax(toy_tree):
    kw = dict(window_size_min=40, uncond_prob=0.3, seed=5)
    ds, jds = blendvoca.BlendVOCATrainDataset(**toy_tree, **kw), jblendvoca.BlendVOCATrainDataset(**toy_tree, **kw)
    assert len(ds) == len(jds) == 6
    assert [(p.person_id, p.sentence_id, p.blendshape_coeffs) for p in ds.data_paths] == \
        [(p.person_id, p.sentence_id, p.blendshape_coeffs) for p in jds.data_paths]
    loader = DataLoader(ds, batch_size=4, sampler_replacement=True, collate_fn=ds.collate_fn, seed=5)
    jloader = JDataLoader(jds, batch_size=4, sampler_replacement=True, collate_fn=jds.collate_fn, seed=5)
    for _ in range(3):  # epochs: the generators carry on
        _same_batches(list(loader), list(jloader))


def test_val_collate_matches_jax(toy_tree):
    ds, jds = blendvoca.BlendVOCAValDataset(**toy_tree, seed=2), jblendvoca.BlendVOCAValDataset(**toy_tree, seed=2)
    assert len(ds) == len(jds) == 3
    for _ in range(2):
        _same_batches(list(DataLoader(ds, collate_fn=ds.collate_fn)), list(JDataLoader(jds, collate_fn=jds.collate_fn)))


def test_blendshape_csv_reads_like_the_jax_package(toy_tree):
    from said_tpu.utils.blendshape import load_blendshape_coeffs as j_load
    from said_tpu_torch.utils.blendshape import load_blendshape_coeffs

    path = os.path.join(toy_tree["blendshape_coeffs_dir"], jblendvoca.PERSON_IDS_VAL[0], "sentence02-1.csv")
    np.testing.assert_array_equal(load_blendshape_coeffs(path), j_load(path))


def test_optimizer_step_refreshes_the_cast_cache():
    """The optimizer updates the parameters in place, which bumps their
    version counters: a bf16 cast cached for sampling before a step is
    rebuilt after it."""
    from said_tpu_torch.cli._common import random_init_
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    pm = random_init_(SAID(audio_config=Wav2Vec2Config.tiny(), dtype=torch.bfloat16), seed=0)
    dense = pm.unet.middle_block[1].transformer_blocks[0].attn1.to_q
    state = said_train.TrainState(pm, said_train.TrainConfig(learning_rate=1e-2))
    batch = {"waveform": torch.from_numpy(_rand((2, 3200), 80)), "coeffs": torch.from_numpy(_rand((2, 12, 32), 81)),
             "cond": torch.tensor([True, True]), "std": None, "blendshape_delta": None}
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        before = dense.weight_as(torch.bfloat16)
    said_train.train_step(state, DiffusionSchedule.create(1000), batch, g)
    with torch.no_grad():
        after = dense.weight_as(torch.bfloat16)
    assert after is not before and torch.equal(after, dense.weight.to(torch.bfloat16))
    assert not torch.equal(after, before)
