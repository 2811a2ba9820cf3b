"""The port's training loss and train-mode model against the JAX package,
on the CPU in float32.

Same weights (``fast_init`` through ``said_tpu_torch.convert``), the same
numpy inputs, injected timesteps and noise, both models deterministic:
the loss within 1e-5 relative, each trainable tensor's gradient within
1e-4 relative L2 (gradients of L1 losses carry a sign that flips where
pred ≈ answer, so a per-element bound would measure the sign of noise).
The port's own train-mode properties follow: the frozen encoder, pads
invisible, dropout stochastic in train mode and off in eval, layerdrop,
gradient checkpointing, and an overfit run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from said_tpu.cli._common import fast_init
from said_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from said_tpu.models.said import SAID as JSAID
from said_tpu.models.wav2vec2 import Wav2Vec2Config as JCfg
from said_tpu.train import said_train as jtrain
from said_tpu_torch.convert import said_state_dict, unet1d_state_dict
from said_tpu_torch.diffusion.schedule import DiffusionSchedule
from said_tpu_torch.models.said import SAID, process_audio
from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from said_tpu_torch.train import said_train

# tests/test_cli_train.py's TINY_AUDIO
TINY = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, output_hidden_size=32)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread is as fast, and under a parallel
    test run (several workers on the machine's cores) far faster than
    threads that wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    jm = JSAID(audio_config=JCfg(**TINY))
    params = jax.tree.map(np.asarray, fast_init(jm, 0))
    pm = SAID(audio_config=Wav2Vec2Config(**TINY))
    pm.load_state_dict({k: _t(v) for k, v in said_state_dict(params).items()}, strict=True)
    return jm, params, pm


def _batch(b=2, window=24, seed=0):
    rng = np.random.default_rng(seed)
    wave = process_audio(rng.standard_normal((b, 16000 * window // 60)).astype(np.float32))
    coeffs = rng.uniform(0, 1, (b, window, 32)).astype(np.float32)
    timesteps = rng.integers(0, 1000, b)
    noise = rng.standard_normal((b, window, 32)).astype(np.float32)
    return dict(waveform=wave, coeffs=coeffs, cond=np.array([True, False][:b]), timesteps=timesteps, noise=noise)


def _jax_loss_and_grads(jm, params, batch, config, std=None, delta=None, **kw):
    schedule = JSchedule.create(1000, config.prediction_type)

    def f(trainable):
        return jtrain.said_loss(
            jm, schedule, jtrain.merge_trainable(params, trainable), jax.random.PRNGKey(0),
            jnp.asarray(batch["waveform"]), jnp.asarray(batch["coeffs"]), jnp.asarray(batch["cond"]),
            None if std is None else jnp.asarray(std), None if delta is None else jnp.asarray(delta), config,
            train=False, timesteps=jnp.asarray(batch["timesteps"]), noise=jnp.asarray(batch["noise"]), **kw)

    (loss, metrics), grads = jax.value_and_grad(f, has_aux=True)(jtrain.trainable_subset(params))
    named = unet1d_state_dict(jax.tree.map(np.asarray, grads["denoiser"]))
    named["null_cond_emb"] = np.asarray(grads["null_cond_emb"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, named


def _port_loss_and_grads(pm, batch, config, std=None, delta=None, **kw):
    schedule = DiffusionSchedule.create(1000, config.prediction_type)
    loss, metrics = said_train.said_loss(
        pm, schedule, _t(batch["waveform"]), _t(batch["coeffs"]), _t(batch["cond"]),
        None if std is None else _t(std), None if delta is None else _t(delta), config, train=False,
        timesteps=_t(batch["timesteps"]), noise=_t(batch["noise"]), **kw)
    params = said_train.trainable_parameters(pm)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, dict(zip(params, grads))


def _compare(j, p):
    (jl, jm_, jg), (pl, pm_, pg) = j, p
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert set(pm_) == set(jm_)
    for k in jm_:
        np.testing.assert_allclose(pm_[k], jm_[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(pg) == set(jg)
    norms = []
    for name, want in jg.items():
        got = pg[name].numpy()
        assert got.shape == want.shape, name
        scale = np.linalg.norm(want)
        norms.append(scale)
        if scale > 0:
            assert np.linalg.norm(got - want) <= GRAD_REL_L2 * scale, name
        else:
            assert np.linalg.norm(got) <= 1e-12, name
    assert np.mean(np.array(norms) > 0) > 0.9  # the comparison is not vacuous


@pytest.mark.parametrize("extras", ["none", "std_and_deltas"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_said_loss_and_grads_match_jax(pair, prediction_type, extras):
    jm, params, pm = pair
    config_j = jtrain.TrainConfig(prediction_type=prediction_type)
    config_p = said_train.TrainConfig(prediction_type=prediction_type)
    batch = _batch()
    kw = {}
    if extras == "std_and_deltas":
        rng = np.random.default_rng(5)
        kw = dict(std=np.linspace(0.5, 2.0, 32).astype(np.float32),
                  delta=rng.standard_normal((2, 32, 20, 3)).astype(np.float32))
    _compare(_jax_loss_and_grads(jm, params, batch, config_j, **kw),
             _port_loss_and_grads(pm, batch, config_p, **kw))


def test_said_loss_and_grads_match_jax_bucketed(pair):
    """A window of 21 real frames padded to 24 (the CLI's bucket of 8):
    masked norms, attention and reductions on both sides."""
    jm, params, pm = pair
    batch = _batch(window=21, seed=3)
    wave_real = batch["waveform"].shape[1]
    batch["waveform"] = np.pad(batch["waveform"], ((0, 0), (0, 6400 - wave_real)))
    for key in ("coeffs", "noise"):
        batch[key] = np.pad(batch[key], ((0, 0), (0, 3), (0, 0)))
    rng = np.random.default_rng(6)
    kw = dict(std=np.linspace(0.5, 2.0, 32).astype(np.float32),
              delta=rng.standard_normal((2, 32, 20, 3)).astype(np.float32))
    want = _jax_loss_and_grads(jm, params, batch, jtrain.TrainConfig(), window_real=jnp.asarray(21),
                               input_length=jnp.asarray(wave_real), **kw)
    got = _port_loss_and_grads(pm, batch, said_train.TrainConfig(), window_real=21, input_length=wave_real, **kw)
    _compare(want, got)


# ------------------------------------------------------- port properties


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _loss(pm, batch, train, generator, config=said_train.TrainConfig(), **kw):
    schedule = DiffusionSchedule.create(1000)
    return said_train.said_loss(
        pm, schedule, _t(batch["waveform"]), _t(batch["coeffs"]), _t(batch["cond"]), None, None, config,
        train=train, timesteps=_t(batch["timesteps"]), noise=_t(batch["noise"]), generator=generator, **kw)[0]


def test_encoder_frozen_and_no_gradient_reaches_it(pair):
    _, _, pm = pair
    state = said_train.TrainState(pm, said_train.TrainConfig())
    assert not any(n.startswith("audio_encoder.") for n in state.params)
    assert not any(p.requires_grad for p in pm.audio_encoder.parameters())
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    batch = _batch()
    loss = _loss(pm, batch, True, _gen(0))
    assert loss.grad_fn is not None
    emb = pm.get_audio_embedding(_t(batch["waveform"]), 24)
    assert emb.grad_fn is None  # the encoder ran under no_grad
    try:
        metrics = said_train.train_step(state, DiffusionSchedule.create(1000), {
            k: _t(v) for k, v in batch.items() if k in ("waveform", "coeffs", "cond")} | {
            "std": None, "blendshape_delta": None}, _gen(1))
        assert metrics["nan_skipped"] == 0.0 and np.isfinite(metrics["loss"])
        after = dict(pm.named_parameters())
        assert all(torch.equal(before[n], after[n]) for n in before if n.startswith("audio_encoder."))
    finally:
        pm.load_state_dict(before)  # the module-scoped pair stays as it was
        for p in pm.parameters():
            p.requires_grad_(True)


def test_padded_loss_blind_to_pad_contents(pair):
    """With window_real/input_length the pads are invisible: garbage in
    place of zeros changes neither the loss nor a gradient."""
    _, _, pm = pair
    batch = _batch(window=21, seed=4)
    wave_real = batch["waveform"].shape[1]
    zero = {k: v for k, v in batch.items()}
    zero["waveform"] = np.pad(batch["waveform"], ((0, 0), (0, 6400 - wave_real)))
    for key in ("coeffs", "noise"):
        zero[key] = np.pad(batch[key], ((0, 0), (0, 3), (0, 0)))
    garbage = dict(zero)
    rng = np.random.default_rng(9)
    garbage["waveform"] = zero["waveform"].copy()
    garbage["waveform"][:, wave_real:] = 5 * rng.standard_normal((2, 6400 - wave_real))
    garbage["coeffs"] = zero["coeffs"].copy()
    garbage["coeffs"][:, 21:] = 5 * rng.standard_normal((2, 3, 32))
    params = list(said_train.trainable_parameters(pm).values())
    out = []
    for b in (zero, garbage):
        loss = _loss(pm, b, False, None, window_real=21, input_length=wave_real)
        out.append((loss, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_train_mode_is_stochastic_and_eval_deterministic(pair):
    _, _, pm = pair
    batch = _batch()
    det = [float(_loss(pm, batch, False, None)) for _ in range(2)]
    assert det[0] == det[1]
    a, a2, b = (float(_loss(pm, batch, True, _gen(s))) for s in (1, 1, 2))
    assert a == a2 and a != b and a != det[0]
    wave = _t(batch["waveform"])
    with torch.no_grad():
        e0 = pm.get_audio_embedding(wave, 24)
        e1 = pm.get_audio_embedding(wave, 24, generator=_gen(3))
        e2 = pm.get_audio_embedding(wave, 24, generator=_gen(4))
    assert (e1 - e0).abs().max() > 1e-6 and (e1 - e2).abs().max() > 1e-6


def test_layerdrop_skips_layers():
    """layerdrop 1.0 skips every layer: the output then equals a model with
    no layers at all."""
    no_dropout = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)
    cfg = Wav2Vec2Config(**dict(TINY, num_hidden_layers=2), layerdrop=1.0, **no_dropout)
    from said_tpu_torch.cli._common import random_init_

    pm = random_init_(SAID(audio_config=cfg), seed=0)
    wave = _t(process_audio(np.random.default_rng(0).standard_normal((1, 6400)).astype(np.float32)))
    with torch.no_grad():
        full = pm.get_audio_embedding(wave, 24)
        dropped = pm.get_audio_embedding(wave, 24, generator=_gen(0))
        layers = pm.audio_encoder.encoder.layers
        pm.audio_encoder.encoder.layers = torch.nn.ModuleList()
        none = pm.get_audio_embedding(wave, 24)
        pm.audio_encoder.encoder.layers = layers
    assert (dropped - full).abs().max() > 1e-6
    torch.testing.assert_close(dropped, none, rtol=0, atol=0)


def test_time_mask_changes_the_embedding(pair):
    _, _, pm = pair
    from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices

    wave = _t(_batch()["waveform"])
    mask = compute_time_mask_indices((2, 24), mask_prob=0.5, mask_length=4, rng=np.random.default_rng(0))
    assert mask.any()
    with torch.no_grad():
        plain = pm.get_audio_embedding(wave, 24)
        masked = pm.get_audio_embedding(wave, 24, mask_time_indices=_t(mask))
    assert (masked - plain).abs().max() > 1e-6


def test_remat_same_loss_and_grads(pair):
    """Gradient checkpointing recomputes every block in the backward pass,
    dropout masks included: same loss, same gradients, and the generator
    left where the run without it leaves it."""
    _, _, pm = pair
    remat = SAID(audio_config=Wav2Vec2Config(**TINY), remat=True)
    remat.load_state_dict(pm.state_dict(), strict=True)
    batch = _batch()
    out = []
    for model in (pm, remat):
        g = _gen(7)
        loss = _loss(model, batch, True, g)
        params = list(said_train.trainable_parameters(model).values())
        out.append((loss, torch.autograd.grad(loss, params), torch.rand(4, generator=g)))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=1e-7)
    torch.testing.assert_close(out[1][2], out[0][2], rtol=0, atol=0)


def test_said_trainer_overfits_one_batch():
    """tests/test_overfit.py's evidence for the port: 100 steps on one batch
    (lr 1e-3) must bring the deterministic eval loss (fixed draws) well
    below its value at init, for the raw weights and for the EMA
    (measured 1.98 → 1.30 raw, 1.25 EMA at these seeds)."""
    from said_tpu_torch.cli._common import random_init_

    torch.manual_seed(0)
    pm = random_init_(SAID(audio_config=Wav2Vec2Config(**TINY)), seed=0)
    schedule = DiffusionSchedule.create(1000)
    config = said_train.TrainConfig(learning_rate=1e-3, encoder_train_mode=False)
    state = said_train.TrainState(pm, config)
    b = _batch(window=16)
    batch = {k: _t(b[k]) for k in ("waveform", "coeffs")} | {"cond": _t(np.array([True, True])), "std": None,
                                                             "blendshape_delta": None}

    def eval_loss():
        return np.mean([said_train.eval_step(pm, schedule, batch, config, _gen(1000 + k))["loss"] for k in range(4)])

    initial = eval_loss()
    g = _gen(42)
    for _ in range(100):
        metrics = said_train.train_step(state, schedule, batch, g)
    assert metrics["nan_skipped"] == 0.0 and state.step == 100
    final = eval_loss()
    with state.ema_weights():
        final_ema = eval_loss()
    assert final < 0.75 * initial, (initial, final)
    assert final_ema < 0.75 * initial, (initial, final_ema)
